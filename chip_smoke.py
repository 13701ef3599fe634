#!/usr/bin/env python3
"""Bring-up smoke test: drive rkmh-tpu's main paths once on one GPU.

    python chip_smoke.py                 # one card, every phase
    python chip_smoke.py --cards 4       # four cards: multi-device commands
                                         # against the same command at
                                         # --devices 1, and nothing else
    python chip_smoke.py --cpu-rehearsal # every phase at a tiny size on the
                                         # CPU (a rehearsal, not a device run)

Every input is generated from --seed (rkmh_tpu.synth) into a scratch
directory; nothing is downloaded.  The commands run the way a user runs
them, through rkmh_tpu.cli.main, in this one process (a second JAX
process could not get the card's memory).  Each phase checks its output
bit for bit against the scalar oracle (rkmh_tpu.oracle): every device
result on these paths is an integer, so there is no tolerance.

The one-card phases, at the shapes of the BASELINE deployments:

1. stream: 60 zika-length references, 1,000,000 reads of 150 bp, -k 12
   -s 1000 (the sort-free rank and the 2-bit packed input wire);
2. stream -M 2 -I 40 with the default 2e8-slot depth counter;
3. hpv16 -k 18 against a 182-type panel plus 10 HPV16 sublineages,
   12,800 nanopore-length reads;
4. hpv16 -M 2 with the default 8e8-slot counter;
5. filter -k 16 -N 25 of the hpv16 reads against one sublineage;
6. call -k 16 -w 100 on a 7,906 bp genome with 20 planted SNPs.

Any failed check or exception exits non-zero before the last line, which
on success is one JSON object naming the device JAX ran on.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import re
import shutil
import socket
import subprocess
import sys
import tempfile
import time


class SmokeFailure(RuntimeError):
    pass


def check(cond, what: str):
    if not cond:
        raise SmokeFailure(what)


def card_facts() -> str:
    """Name and power limit of the cards, read by a child process that
    never imports JAX."""
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e.__class__.__name__})"
    return r.stdout.strip().replace("\n", " | ") or "nvidia-smi printed nothing"


# sizes: (chip, cpu rehearsal)
SIZES = {
    "chip": dict(zika_refs=60, zika_len=10_794, zika_reads=1_000_000,
                 parity_reads=2_000, hpv_types=182, hpv_len=7_900,
                 hpv_reads=12_800, hpv_mean=4_500, hpv_sd=1_200,
                 hpv_parity=100, hpv_m_parity=300, filter_parity=2_000,
                 call_len=7_906, call_snps=20, call_reads=1_100, call_mean=4_500,
                 stream_counter=None, hpv_counter=None,
                 card_zika_reads=131_072, card_hpv_reads=1_600, card_hpv_sd=100),
    "cpu": dict(zika_refs=8, zika_len=1_200, zika_reads=3_000,
                parity_reads=200, hpv_types=16, hpv_len=900,
                hpv_reads=48, hpv_mean=400, hpv_sd=150,
                hpv_parity=48, hpv_m_parity=24, filter_parity=48,
                call_len=600, call_snps=8, call_reads=60, call_mean=300,
                stream_counter=1 << 20, hpv_counter=1 << 20,
                card_zika_reads=1_000, card_hpv_reads=24, card_hpv_sd=20),
}


class Smoke:
    def __init__(self, args):
        self.args = args
        self.size = SIZES["cpu" if args.cpu_rehearsal else "chip"]
        self.work = args.workdir or tempfile.mkdtemp(prefix="rkmh_smoke_")
        os.makedirs(self.work, exist_ok=True)
        self.card = card_facts()
        self._compile_s = 0.0

    # ------------------------------------------------------------------
    def path(self, name: str) -> str:
        return os.path.join(self.work, name)

    def on_duration(self, event: str, secs: float, **_):
        if event.startswith("/jax/core/compile/"):
            self._compile_s += secs

    def cli(self, *argv) -> str:
        """Run one rkmh-tpu command in-process; returns its stderr."""
        from rkmh_tpu.cli import main

        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            rc = main([str(a) for a in argv])
        check(rc == 0, f"rkmh-tpu {' '.join(map(str, argv))} exited {rc}: "
                       f"{err.getvalue()[-2000:]}")
        return err.getvalue()

    def phase(self, name: str, fn):
        import jax

        c0, t0 = self._compile_s, time.perf_counter()
        reads = fn()
        wall = time.perf_counter() - t0
        stats = jax.devices()[0].memory_stats() or {}
        peak = stats.get("peak_bytes_in_use", "not available")
        print(f"phase {name}: passed | reads {reads} | wall {wall:.3f} s "
              f"(compile {self._compile_s - c0:.3f} s) | "
              f"peak_bytes_in_use {peak} | card {self.card}", flush=True)

    # ------------------------------------------------------------------
    def make_inputs(self, zika_reads: int, hpv_reads: int, hpv_sd: int):
        import numpy as np

        from rkmh_tpu import synth

        z = self.size
        self.zika_reads_all = range(zika_reads)
        rng = np.random.default_rng(self.args.seed)
        self.zika_refs = synth.zika_panel(rng, z["zika_refs"], z["zika_len"])
        synth.write_fasta(self.path("zika.refs.fa"), self.zika_refs)
        srcs = [r.seq for r in self.zika_refs]
        self.zika_head = synth.write_fastq(self.path("zika.fq"), synth.iter_reads(
            rng, srcs, zika_reads, length=synth.ZIKA_READ_LEN,
            sub_rate=0.01, n_run_frac=0.03, prefix="z"))[: z["parity_reads"]]
        self.zika_small = synth.write_fastq(self.path("zika_small.fq"), next(
            synth.iter_reads(rng, srcs, z["parity_reads"],
                             length=synth.ZIKA_READ_LEN, sub_rate=0.01,
                             n_run_frac=0.03, prefix="zs")))

        self.types, self.subs = synth.hpv_refpath(
            self.path("hpvref"), rng, z["hpv_types"], z["hpv_len"])
        hsrc = [s.seq for s in self.subs] * (len(self.types) // len(self.subs)) \
            + [t.seq for t in self.types]
        hkw = dict(mean_len=z["hpv_mean"], sd_len=hpv_sd,
                   min_len=z["hpv_mean"] // 4, sub_rate=0.05, n_run_frac=0.02)
        self.hpv = synth.write_fastq(self.path("hpv.fq"), next(synth.iter_reads(
            rng, hsrc, hpv_reads, prefix="h", chunk=hpv_reads, **hkw)))
        self.hpv_small = synth.write_fastq(self.path("hpv_small.fq"), next(
            synth.iter_reads(rng, hsrc, z["hpv_m_parity"], prefix="hs", **hkw)))
        synth.write_fasta(self.path("a1.fa"), [self.subs[0]])

        genome = synth.to_bytes(synth.random_codes(rng, z["call_len"]))
        self.call_ref = genome
        synth.write_fasta(self.path("call_ref.fa"),
                          [synth.SeqRecord("callref", genome)])
        mutated, self.snps = synth.plant_snps(genome, z["call_snps"], rng)
        self.call_reads = synth.write_fastq(self.path("call.fq"), next(
            synth.iter_reads(rng, [mutated], z["call_reads"],
                             mean_len=z["call_mean"], sd_len=z["call_mean"] // 5,
                             min_len=z["call_mean"] // 2, prefix="c",
                             chunk=z["call_reads"])))

    @staticmethod
    def lines(path: str):
        with open(path, "rb") as fh:
            return fh.read().decode().splitlines(keepends=True)

    def counter_flags(self, key: str):
        c = self.size[key]
        return [] if c is None else ["--counter-size", c]

    # ------------------------------------------------------------------
    def run_one_card(self):
        from rkmh_tpu import oracle
        from rkmh_tpu.classify import engine

        z = self.size
        refs, zfq = self.path("zika.refs.fa"), self.path("zika.fq")

        def stream():
            out = self.path("stream.out")
            self.cli("stream", "-r", refs, "-f", zfq, "-k", 12, "-s", 1000,
                     "-o", out)
            got = self.lines(out)
            check(len(got) == z["zika_reads"],
                  f"stream: {len(got)} lines for {z['zika_reads']} reads")
            want = oracle.stream_lines(self.zika_refs, self.zika_head, 12, 1000)
            check(got[: len(want)] == want,
                  f"stream: first {len(want)} lines differ from the oracle")
            # 150 bp reads pad to 160: W = 149 windows <= s, the sort-free
            # rank's regime, and 160 packs into whole bytes
            nosort = engine.use_nosort(149, 1000, engine.accel_branches())
            packed = engine.pack4_ok(160)
            print(f"stream: sort-free rank {nosort}, packed input wire {packed}",
                  flush=True)
            check(self.args.cpu_rehearsal or (nosort and packed),
                  "stream: the accelerator branches were not taken")
            return len(got)

        def stream_m():
            cflags = self.counter_flags("stream_counter")
            csize = z["stream_counter"] or 200_000_000
            out = self.path("stream_m.out")
            self.cli("stream", "-r", refs, "-f", zfq, "-k", 12, "-s", 1000,
                     "-M", 2, "-I", 40, *cflags, "-o", out)
            n = len(self.lines(out))
            check(n == z["zika_reads"], f"stream -M: {n} lines")
            small = self.path("stream_m_small.out")
            self.cli("stream", "-r", refs, "-f", self.path("zika_small.fq"),
                     "-k", 12, "-s", 1000, "-M", 2, "-I", 40, *cflags,
                     "-o", small)
            want = oracle.stream_lines(self.zika_refs, self.zika_small, 12, 1000,
                                       min_kmer_occ=2, max_samples=40,
                                       counter_size=csize)
            check(self.lines(small) == want,
                  "stream -M 2 -I 40: output differs from the oracle")
            return n + len(want)

        def hpv16(extra=(), reads_file="hpv.fq", out_name="hpv16.out"):
            out = self.path(out_name)
            err = self.cli("hpv16", "-R", self.path("hpvref"), "-f",
                           self.path(reads_file), "-k", 18, *extra, "-o", out)
            return self.lines(out), err

        def hpv16_plain():
            got, err = hpv16()
            check(len(got) == len(self.hpv), f"hpv16: {len(got)} lines")
            m = re.search(r"set table (\d+) bytes", err)
            check(m is not None, "hpv16: no set-table size on stderr")
            print(f"hpv16: combined set table {m.group(1)} bytes", flush=True)
            n = z["hpv_parity"]
            want = oracle.hpv16_lines(self.types, self.subs, self.hpv[:n], 18)
            check([l.rstrip("\n") for l in got[:n]] == want,
                  f"hpv16: first {n} lines differ from the oracle")
            return len(got)

        def hpv16_m():
            cflags = self.counter_flags("hpv_counter")
            csize = z["hpv_counter"] or 800_000_000
            got, _ = hpv16(("-M", 2, *cflags), out_name="hpv16_m.out")
            check(len(got) == len(self.hpv), f"hpv16 -M: {len(got)} lines")
            small, _ = hpv16(("-M", 2, *cflags), "hpv_small.fq", "hpv16_ms.out")
            want = oracle.hpv16_lines(self.types, self.subs, self.hpv_small, 18,
                                      min_kmer_occ=2, counter_size=csize)
            check([l.rstrip("\n") for l in small] == want,
                  "hpv16 -M 2: output differs from the oracle")
            return len(got) + len(small)

        def filt():
            out = self.path("filter.out")
            self.cli("filter", "-r", self.path("a1.fa"), "-f",
                     self.path("hpv.fq"), "-k", 16, "-N", 25, "-o", out)
            got = self.lines(out)
            check(len(got) % 4 == 0, "filter: output is not whole records")
            n = z["filter_parity"]
            head = [r for r in range(0, len(got), 4)
                    if int(got[r][2:].strip()) < n]
            got_head = "".join("".join(got[r: r + 4]) for r in head)
            want = oracle.filter_records([self.subs[0]], self.hpv[:n], 16, 1000,
                                         min_matches=25)
            check(got_head == want,
                  f"filter: records of the first {n} reads differ from the oracle")
            kept = want.count("\n+\n")
            check(0 < kept < n, f"filter: {kept} of {n} reads pass; the check cannot bite")
            print(f"filter: {len(got) // 4} of {len(self.hpv)} reads pass", flush=True)
            return len(self.hpv)

        def call():
            out = self.path("call.vcf")
            self.cli("call", "-r", self.path("call_ref.fa"), "-f",
                     self.path("call.fq"), "-k", 16, "-w", 100, "-o", out)
            body = [l.rstrip("\n") for l in self.lines(out) if not l.startswith("##")]
            want = oracle.call_vcf_body("callref", self.call_ref,
                                        [r.seq for r in self.call_reads], 16, 100)
            check(body == want, "call: VCF records differ from the oracle")
            check(len(want) > 0, "call: no variant called")
            print(f"call: {len(want)} VCF records for {len(self.snps)} planted SNPs",
                  flush=True)
            return len(self.call_reads)

        self.phase("stream -k 12 -s 1000", stream)
        self.phase("stream -M 2 -I 40", stream_m)
        self.phase("hpv16 -k 18", hpv16_plain)
        self.phase("hpv16 -k 18 -M 2", hpv16_m)
        self.phase("filter -k 16 -N 25", filt)
        self.phase("call -k 16 -w 100", call)

    # ------------------------------------------------------------------
    def run_dist(self, procs: int) -> str:
        """stream over --dist-procs ranks, one process per card, merged by
        rkmh-tpu-dist-merge.  Runs before this process touches a card."""
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        out = self.path("dist.out")
        t0 = time.perf_counter()
        child = ("import sys, jax; from rkmh_tpu.cli import main; "
                 "rc = main(sys.argv[1:]); d = jax.local_devices(); "
                 "print(f'RANK_DEVICES {d[0].platform} {len(d)}', file=sys.stderr); "
                 "sys.exit(rc)")
        env = dict(os.environ)
        if self.args.cpu_rehearsal:
            env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=1"
        repo = os.path.dirname(os.path.abspath(__file__))
        env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
        ps = [subprocess.Popen(
            [sys.executable, "-c", child, "stream", "-r", self.path("zika.refs.fa"),
             "-f", self.path("zika.fq"), "-k", "12", "-s", "1000",
             "--dist-coordinator", f"localhost:{port}",
             "--dist-procs", str(procs), "--dist-rank", str(r), "-o", out],
            cwd=self.work, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True) for r in range(procs)]
        try:
            res = [p.communicate(timeout=900) for p in ps]
        finally:
            for p in ps:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for r, (p, (_, err)) in enumerate(zip(ps, res)):
            check(p.returncode == 0, f"dist rank {r} exited {p.returncode}: {err[-2000:]}")
            m = re.search(r"RANK_DEVICES (\w+) (\d+)", err)
            check(m is not None, f"dist rank {r} did not report its devices")
            want_plat = "cpu" if self.args.cpu_rehearsal else "gpu"
            check(m.group(1) == want_plat and m.group(2) == "1",
                  f"dist rank {r} ran on {m.group(1)} x{m.group(2)}, not one {want_plat} card")
        from rkmh_tpu.commands.dist_stream import merge_main

        merged = io.StringIO()
        with contextlib.redirect_stdout(merged):
            check(merge_main([f"{out}.{r}" for r in range(procs)]) == 0,
                  "rkmh-tpu-dist-merge failed")
        print(f"stream --dist-procs {procs}: {procs} ranks ran and merged in "
              f"{time.perf_counter() - t0:.3f} s", flush=True)
        return merged.getvalue()

    def run_cards(self, n: int, dist_out: str):
        def same(name, base, reads, *multi):
            def fn():
                one = self.path(f"{name}.1.out")
                many = self.path(f"{name}.{n}.out")
                self.cli(*base, "-o", one)
                err = self.cli(*base, *multi, "-o", many)
                flags = " ".join(map(str, multi))
                check("ignored" not in err, f"{name}: {flags} fell back: {err[-500:]}")
                a, b = open(one, "rb").read(), open(many, "rb").read()
                check(a == b, f"{name}: {flags} differs from --devices 1")
                check(len(a) > 0, f"{name}: empty output")
                print(f"{name}: {flags} byte-identical to --devices 1 "
                      f"({len(a)} bytes)", flush=True)
                return reads
            return fn

        zs = ["stream", "-r", self.path("zika.refs.fa"), "-f",
              self.path("zika.fq"), "-k", 12, "-s", 1000]
        hp = ["hpv16", "-R", self.path("hpvref"), "-f", self.path("hpv.fq"),
              "-k", 18]
        cl = ["call", "-r", self.path("call_ref.fa"), "-f",
              self.path("call.fq"), "-k", 16, "-w", 100]
        nz, nh, nc = len(self.zika_reads_all), len(self.hpv), len(self.call_reads)
        self.phase(f"stream --devices {n}",
                   same("stream_dp", zs, nz, "--devices", n))
        self.phase(f"stream --devices {n} --tp 2",
                   same("stream_tp", zs, nz, "--devices", n, "--tp", 2))
        self.phase(f"stream -M 2 --devices {n}",
                   same("stream_m", zs + ["-M", 2, *self.counter_flags("stream_counter")],
                        nz, "--devices", n))
        self.phase(f"hpv16 --devices {n} --tp 2",
                   same("hpv16_tp", hp, nh, "--devices", n, "--tp", 2))
        self.phase(f"call --devices {n}", same("call_dp", cl, nc, "--devices", n))

        def dist():
            single = open(self.path("stream_dp.1.out")).read()
            check(dist_out == single,
                  f"stream --dist-procs {n}: merged output differs from --devices 1")
            print(f"stream --dist-procs {n}: merged stripes byte-identical to "
                  f"--devices 1 ({len(single)} bytes)", flush=True)
            return nz

        self.phase(f"stream --dist-procs {n}", dist)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cards", type=int, default=1, choices=(1, 4),
                    help="4: run only the multi-device commands, each "
                         "against the same command at --devices 1")
    ap.add_argument("--cpu-rehearsal", action="store_true",
                    help="every phase at a tiny size on the CPU; prints no "
                         "device result")
    ap.add_argument("--workdir", default="",
                    help="scratch directory for inputs and outputs "
                         "(default: a fresh temporary directory, removed)")
    args = ap.parse_args(argv)

    if args.cpu_rehearsal:
        os.environ["JAX_PLATFORMS"] = "cpu"
        os.environ["XLA_FLAGS"] = (
            f"--xla_force_host_platform_device_count={args.cards}")
    # every cache stays inside the scratch directory
    os.environ.setdefault("RKMH_TPU_PANEL_CACHE", "0")
    os.environ.setdefault("RKMH_TPU_INPUT_INDEX", "0")

    import jax

    import rkmh_tpu  # noqa: F401  (x64 + compile cache)

    smoke = Smoke(args)
    cwd = os.getcwd()

    def device_facts():
        from rkmh_tpu.io.native import load as native_load

        devs = jax.devices()
        d0 = devs[0]
        print(f"jax {jax.__version__} devices {devs}", flush=True)
        print(f"device_kind {d0.device_kind!r} count {len(devs)}", flush=True)
        print(f"compile cache {jax.config.jax_compilation_cache_dir}", flush=True)
        print(f"native io library loaded: {native_load() is not None}", flush=True)
        print(f"card {smoke.card}", flush=True)
        want = "cpu" if args.cpu_rehearsal else "gpu"
        check(d0.platform == want, f"JAX runs on {d0.platform!r}, not {want!r}")
        check(len(devs) >= args.cards, f"{len(devs)} devices, {args.cards} asked")
        return devs

    try:
        os.chdir(smoke.work)  # hpv16 writes its .tst side file to the CWD
        t0 = time.perf_counter()
        z = smoke.size
        if args.cards > 1:
            # a narrow read-length spread keeps hpv16 to few compiled shapes
            smoke.make_inputs(z["card_zika_reads"], z["card_hpv_reads"],
                              z["card_hpv_sd"])
            # the ranks take the cards before this process touches them
            dist_out = smoke.run_dist(args.cards)
            devs = device_facts()
        else:
            devs = device_facts()  # fail before generating anything
            smoke.make_inputs(z["zika_reads"], z["hpv_reads"], z["hpv_sd"])
        print(f"inputs generated from seed {args.seed} in "
              f"{time.perf_counter() - t0:.3f} s", flush=True)
        jax.monitoring.register_event_duration_secs_listener(smoke.on_duration)

        if args.cards > 1:
            smoke.run_cards(args.cards, dist_out)
        else:
            smoke.run_one_card()
        print(f"all phases passed in {time.perf_counter() - t0:.3f} s", flush=True)
    finally:
        os.chdir(cwd)
        if not args.workdir:
            shutil.rmtree(smoke.work, ignore_errors=True)

    d0 = devs[0]
    if args.cpu_rehearsal:
        print(json.dumps({"cpu_rehearsal": "passed", "device_run": False}))
        return 0
    print(f"card {smoke.card}")
    print(json.dumps({"ok": True, "device": {
        "platform": d0.platform, "kind": d0.device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
