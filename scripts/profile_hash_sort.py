"""Time the XLA hash fusion and the u64 row sort on the accelerator.

    python scripts/profile_hash_sort.py [--out TRACE_DIR]

1. The canonical k-mer window hash (ops.hashing.multi_k_window_hashes)
   jitted alone at the zika shape (16,384 reads x 160 codes, k=12) and the
   hpv16 shape (512 reads x 4,608 codes, k=18).  Kernel time is the sum of
   the device events of a profiler trace of a few calls; bytes are 1 per
   base in and 8 per window out; the share is of 3.35 TB/s (H100 SXM).
2. The two forms of an ascending u64 row sort at the hpv16 full-row width
   (512 x 4,591) and the zika width (16,384 x 149): jnp.sort on u64, and a
   two-key (hi, lo) u32 lax.sort.  Both must give the same rows.
3. The kernels of one whole device step, by share of the step: the zika
   classify step (16,384 reads of 150 bp, packed wire, 60-strain panel)
   and the hpv16 k=18 step (512 reads of 4,500 bp, combined set table of
   a 182-type panel), on seeded inputs (rkmh_tpu.synth).

Prints one line per measurement and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import glob
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import rkmh_tpu  # noqa: E402,F401  (x64)
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from rkmh_tpu.ops.hashing import multi_k_window_hashes  # noqa: E402

PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)


def pair_sort(x):
    lo = x.astype(jnp.uint32)
    hi = (x >> np.uint64(32)).astype(jnp.uint32)
    shi, slo = jax.lax.sort((hi, lo), num_keys=2, dimension=-1)
    return slo.astype(jnp.uint64) | (shi.astype(jnp.uint64) << np.uint64(32))


def wall(fn, *args, iters: int = 20) -> float:
    """Best-of-3 mean seconds per call, ending in block_until_ready."""
    jax.block_until_ready(fn(*args))
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(iters):
            y = fn(*args)
        jax.block_until_ready(y)
        best = min(best, (time.perf_counter() - t0) / iters)
    return best


def device_events(trace_dir: str):
    """(name, total ns) of every event on the device planes of a trace."""
    paths = glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"), recursive=True)
    prof = jax.profiler.ProfileData.from_file(max(paths, key=os.path.getmtime))
    tot: dict[str, int] = {}
    for plane in prof.planes:
        if "/device:" not in plane.name:
            continue
        lines = list(plane.lines)
        print(f"  trace plane {plane.name}: lines {[l.name for l in lines]}")
        # kernels appear once on "XLA Ops" and again on their stream line
        ops = [l for l in lines if l.name == "XLA Ops"] or \
            [l for l in lines if "Stream" in l.name]
        for line in ops:
            for ev in line.events:
                tot[ev.name] = tot.get(ev.name, 0) + ev.duration_ns
    return tot


def hash_fusion(name: str, B: int, L: int, k: int, reps: int, out: str):
    codes = jnp.asarray(np.random.default_rng(0).integers(0, 4, (B, L), np.uint8))
    fn = jax.jit(lambda c: multi_k_window_hashes(c, [k]))
    jax.block_until_ready(fn(codes))
    tdir = tempfile.mkdtemp(prefix=f"trace_{name}_", dir=out)
    with jax.profiler.trace(tdir):
        for _ in range(reps):
            y = fn(codes)
        jax.block_until_ready(y)
    ev = device_events(tdir)
    if not ev:
        print(f"hash {name}: no device events in the trace", flush=True)
        return
    kern_s = sum(ev.values()) / 1e9 / reps
    W = L - k + 1
    nbytes = B * L + B * W * 8
    print(f"hash {name}: B={B} L={L} k={k} | kernels "
          + ", ".join(f"{n} {d / 1e3 / reps:.1f} us" for n, d in sorted(ev.items()))
          + f" | kernel {kern_s * 1e6:.1f} us/call | wall {wall(fn, codes) * 1e6:.1f} us/call"
          + f" | bytes {nbytes} | {nbytes / kern_s / 1e9:.1f} GB/s = "
          f"{nbytes / kern_s / PEAK_BYTES_PER_S:.3f} of 3.35 TB/s", flush=True)


def sorts(name: str, B: int, W: int):
    x = jnp.asarray(np.random.default_rng(1).integers(0, 2**64, (B, W), np.uint64))
    a = jax.jit(lambda v: jnp.sort(v, axis=-1))
    b = jax.jit(pair_sort)
    assert np.array_equal(np.asarray(a(x)), np.asarray(b(x)))
    ta, tb = wall(a, x), wall(b, x)
    tb2, ta2 = wall(b, x), wall(a, x)
    print(f"sort {name}: [{B}, {W}] u64 | jnp.sort {ta * 1e6:.1f} / {ta2 * 1e6:.1f} us "
          f"| two-key u32 lax.sort {tb * 1e6:.1f} / {tb2 * 1e6:.1f} us", flush=True)


def traced(name: str, fn, args, reps: int, out: str):
    """Per-kernel device time of `reps` calls of fn(*args), largest first."""
    jax.block_until_ready(fn(*args))
    tdir = tempfile.mkdtemp(prefix=f"trace_{name}_", dir=out)
    with jax.profiler.trace(tdir):
        for _ in range(reps):
            y = fn(*args)
        jax.block_until_ready(y)
    ev = device_events(tdir)
    total = sum(ev.values())
    step_wall = wall(fn, *args, iters=10)
    print(f"step {name}: device {total / 1e3 / reps:.1f} us/call | wall "
          f"{step_wall * 1e6:.1f} us/call | kernels: "
          + ", ".join(f"{n} {d / 1e3 / reps:.1f} us ({d / total:.1%})"
                      for n, d in sorted(ev.items(), key=lambda kv: -kv[1])[:12]),
          flush=True)


def step_breakdown(out: str):
    from rkmh_tpu import synth
    from rkmh_tpu.classify import engine
    from rkmh_tpu.commands.hpv16_cmd import Hpv16Config, build_tables
    from rkmh_tpu.io.packing import encode_seqs, pack_codes4
    from rkmh_tpu.ops.lookup import build_panel_table

    rng = np.random.default_rng(0)
    refs = synth.zika_panel(rng)
    rcodes, _ = encode_seqs([r.seq for r in refs], pad_to=10_880)
    sk, lens = engine.build_ref_sketches(rcodes, (12,), 1000)
    table = jnp.asarray(build_panel_table(np.asarray(sk), np.asarray(lens)).table)
    reads = next(synth.iter_reads(rng, [r.seq for r in refs], 16384, length=150,
                                  sub_rate=0.01, n_run_frac=0.03))
    codes, _ = encode_seqs([r.seq for r in reads], pad_to=160)
    pk, vb = (jnp.asarray(a) for a in pack_codes4(codes))

    def zika_step(pk, vb, table):
        return engine.classify_packed4_table_packed2(
            pk, vb, 160, table, ks=(12,), sketch_size=1000, num_refs=60,
            min_diff=0, min_matches=-1, accel=True)

    traced("zika classify", zika_step, (pk, vb, table), 5, out)

    ref_dir = tempfile.mkdtemp(prefix="hpvref_", dir=out)
    types, subs = synth.hpv_refpath(ref_dir, rng)
    cwd = os.getcwd()
    os.chdir(ref_dir)  # build_tables writes its .tst side file here
    try:
        tb = build_tables(Hpv16Config(refpath=ref_dir), (18,))
    finally:
        os.chdir(cwd)
    hreads = next(synth.iter_reads(rng, [s_.seq for s_ in subs] + [t.seq for t in types],
                                   512, length=4500, sub_rate=0.05))
    hcodes, hlens = encode_seqs([r.seq for r in hreads], pad_to=4608)
    Wc = engine.hpv16_compact_width(hlens, 4608, (18,))
    hpk, hvb = (jnp.asarray(a) for a in pack_codes4(hcodes))

    def hpv16_step(pk, vb, table):
        return engine.hpv16_packed4_batch_comb(
            pk, vb, 4608, table, (18,), len(tb.type_names), tb.n_lin + tb.n_sub, Wc)

    traced("hpv16 k=18", hpv16_step, (hpk, hvb, tb.comb_table), 5, out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="",
                    help="directory for the traces (default: a fresh temporary one)")
    args = ap.parse_args(argv)
    args.out = args.out or tempfile.mkdtemp(prefix="profile_hash_sort_")
    os.makedirs(args.out, exist_ok=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    d = jax.devices()[0]
    print(f"device {d.platform} {d.device_kind!r} | card {smi.stdout.strip()}", flush=True)
    hash_fusion("zika", 16384, 160, 12, 10, args.out)
    hash_fusion("hpv16", 512, 4608, 18, 10, args.out)
    sorts("hpv16", 512, 4591)
    sorts("zika", 16384, 149)
    step_breakdown(args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
