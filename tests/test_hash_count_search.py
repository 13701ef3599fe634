"""hash / count / search commands + JSON sketch round-trip.

Oracle-based: every device-produced value is checked against the scalar
Python oracle (rkmh_tpu.oracle), which is itself validated bit-exactly
against MurmurHash3_x64_128 golden vectors in test_murmur3.py.
"""

import io
import json

import numpy as np
import pytest

from rkmh_tpu import oracle, synth


@pytest.fixture(scope="module")
def zika_files(tmp_path_factory):
    """Seeded zika-shaped inputs: a 60-strain panel of 10,794 bp genomes
    and 1,000 reads of 150 bp (1% substitutions, some with an N run)."""
    tmp = tmp_path_factory.mktemp("zika")
    rng = np.random.default_rng(12)
    refs = synth.zika_panel(rng)
    reads = next(synth.iter_reads(rng, [r.seq for r in refs], 1000,
                                  length=150, sub_rate=0.01,
                                  n_run_frac=0.03, prefix="z"))
    rp, fp = str(tmp / "zika.refs.fa"), str(tmp / "z1.fq")
    synth.write_fasta(rp, refs)
    synth.write_fastq(fp, reads)
    return rp, fp, reads


@pytest.fixture(scope="module")
def zika_reads(zika_files):
    return zika_files[2][:40]


def run_cmd(cfg_cls, run_fn, **kw):
    buf = io.StringIO()
    cfg = cfg_cls(**kw)
    rc = run_fn(cfg, out=buf)
    assert rc == 0
    return buf.getvalue()


# ---------------------------------------------------------------------------
# hash
# ---------------------------------------------------------------------------

def test_hash_lines_match_oracle(tmp_path, zika_reads):
    from rkmh_tpu.commands.hash_cmd import HashConfig, run

    fq = tmp_path / "reads.fq"
    with open(fq, "w") as fh:
        for r in zika_reads[:8]:
            fh.write(f"@{r.name}\n{r.seq.decode()}\n+\n{(r.qual or b'I'*len(r.seq)).decode()}\n")

    out = run_cmd(HashConfig, run, read_files=[str(fq)], ks=(12,))
    lines = out.strip().split("\n")
    assert len(lines) == 8
    for line, rec in zip(lines, zika_reads[:8]):
        name, vals = line.split("\t")
        assert name == rec.name
        got = [int(v) for v in vals.split()]
        assert got == oracle.calc_hashes(rec.seq, 12)


def test_hash_multi_k_concatenates(tmp_path, zika_reads):
    from rkmh_tpu.commands.hash_cmd import HashConfig, run

    fq = tmp_path / "r.fa"
    rec = zika_reads[0]
    fq.write_text(f">{rec.name}\n{rec.seq.decode()}\n")
    out = run_cmd(HashConfig, run, read_files=[str(fq)], ks=(12, 16))
    _, vals = out.strip().split("\t")
    got = [int(v) for v in vals.split()]
    assert got == oracle.calc_hashes(rec.seq, [12, 16])


def test_hash_kmers_output(tmp_path):
    from rkmh_tpu.commands.hash_cmd import HashConfig, run

    fa = tmp_path / "x.fa"
    fa.write_text(">s\nACGTAC\n")
    out = run_cmd(HashConfig, run, read_files=[str(fa)], ks=(4,), output_kmers=True)
    assert out == "ACGT\ts\nCGTA\ts\nGTAC\ts\n"


def test_hash_wabbitize_format(tmp_path):
    from rkmh_tpu.commands.hash_cmd import HashConfig, run

    fa = tmp_path / "x.fa"
    fa.write_text(">a|b\nACGTACGTACGT\n")
    out = run_cmd(
        HashConfig, run, read_files=[str(fa)], ks=(4,), sketch_size=3, wabbitize=True
    )
    mins = oracle.minhashes(oracle.calc_hashes(b"ACGTACGTACGT", 4), 3)
    feats = " ".join(f"{m}:1" for m in mins)
    # print_wabbit layout (rkmh.cpp:463-487): '|' in key -> '_'
    assert out == f"XYX 1.0 `a_b|vir {feats} |sketch k:4 s:3\n"


def test_hash_json_roundtrip_classify(tmp_path, zika_files):
    """hash -o panel.json on refs, then stream --ref-sketches gives
    byte-identical output to the direct hashing path."""
    from rkmh_tpu.commands.hash_cmd import HashConfig, run as run_hash
    from rkmh_tpu.commands.stream import StreamConfig, run as run_stream

    refs_fa, reads_fq, _ = zika_files
    prefix = str(tmp_path / "panel")
    rc = run_hash(
        HashConfig(
            read_files=[refs_fa], ks=(12,), sketch_size=1000,
            out_prefix=prefix,
        )
    )
    assert rc == 0

    with open(f"{prefix}.rkmh.json") as fh:
        data = json.load(fh)
    assert len(data) == 60 and data[0]["hash_seed"] == 42

    buf_a, buf_b = io.StringIO(), io.StringIO()
    common = dict(read_files=[reads_fq], ks=(12,), sketch_size=1000)
    run_stream(StreamConfig(ref_files=[refs_fa], **common), out=buf_a)
    run_stream(
        StreamConfig(ref_sketches=f"{prefix}.rkmh.json", **common), out=buf_b
    )
    assert buf_a.getvalue() == buf_b.getvalue()
    assert buf_a.getvalue().count("\n") == 1000


# ---------------------------------------------------------------------------
# count
# ---------------------------------------------------------------------------

def test_count_table_matches_oracle(tmp_path, zika_reads):
    from rkmh_tpu.commands.count_cmd import CountConfig, run

    fq = tmp_path / "r.fq"
    with open(fq, "w") as fh:
        for r in zika_reads[:10]:
            fh.write(f"@{r.name}\n{r.seq.decode()}\n+\n{'I'*len(r.seq)}\n")

    size = 4096
    npz = tmp_path / "table.npz"
    run_cmd(
        CountConfig, run,
        read_files=[str(fq)], ks=(12,), counter_size=size, out_file=str(npz),
    )
    table = np.load(npz)["table"]

    want = np.zeros(size, dtype=np.int64)
    for r in zika_reads[:10]:
        for h in oracle.calc_hashes(r.seq, 12):
            want[h % size] += 1  # zeros counted too, like HASHTCounter
    assert np.array_equal(table, want)


# ---------------------------------------------------------------------------
# search
# ---------------------------------------------------------------------------

def test_search_finds_ref_kmers(tmp_path, zika_reads):
    from rkmh_tpu.commands.search_cmd import SearchConfig, run

    k = 12
    rec = zika_reads[0]
    # ref kmer list: every 7th kmer of the first read
    ref_kmers = [rec.seq[i : i + k].decode() for i in range(0, len(rec.seq) - k + 1, 7)]
    ref_txt = tmp_path / "ref.txt"
    ref_txt.write_text("".join(f"{m} extra tokens\n" for m in ref_kmers))

    fq = tmp_path / "r.fq"
    with open(fq, "w") as fh:
        for r in zika_reads[:5]:
            fh.write(f"@{r.name}\n{r.seq.decode()}\n+\n{'I'*len(r.seq)}\n")

    out = run_cmd(
        SearchConfig, run, ref_files=[str(ref_txt)], read_files=[str(fq)], ks=(k,)
    )
    lines = out.strip("\n").split("\n")
    assert len(lines) == 5

    ref_set = {oracle.calc_hash(m) for m in ref_kmers} - {0}
    for line, r in zip(lines, zika_reads[:5]):
        name, mers = (line.split("\t") + [""])[:2]
        assert name == r.name
        want = [
            r.seq[i : i + k].decode()
            for i in range(len(r.seq) - k + 1)
            if oracle.calc_hash(r.seq[i : i + k]) in ref_set
        ]
        got = mers.split(",") if mers else []
        assert got == want
    # the read that supplied the kmers must recover them all
    assert set(ref_kmers) <= set(lines[0].split("\t")[1].split(","))


# ---------------------------------------------------------------------------
# --devices: dp-sharded hashing, byte-identical to single-device
# ---------------------------------------------------------------------------

def test_dpctx_maybe_falls_back_gracefully(zika_files):
    """--devices beyond the visible device count must degrade to
    single-device with a logged reason (common.DpCtx.maybe), not crash
    in make_mesh — and the output stays identical."""
    from rkmh_tpu.commands.common import DpCtx
    from rkmh_tpu.commands.count_cmd import CountConfig, run as count_run

    assert DpCtx.maybe(0) is None
    assert DpCtx.maybe(1) is None
    assert DpCtx.maybe(999) is None  # > visible -> logged fallback
    assert DpCtx.maybe(2) is not None  # virtual 8-device mesh

    reads_fq = zika_files[1]
    a, b = io.StringIO(), io.StringIO()
    assert count_run(CountConfig(read_files=[reads_fq], ks=(12,),
                                 counter_size=1 << 14, dump=True,
                                 devices=999), out=a) == 0
    assert count_run(CountConfig(read_files=[reads_fq], ks=(12,),
                                 counter_size=1 << 14, dump=True), out=b) == 0
    assert a.getvalue() == b.getvalue()


def test_hash_count_search_devices_byte_identical(tmp_path, zika_reads):
    """hash/count/search --devices N match single-device output exactly
    (DpCtx row sharding; no cross-read op exists to perturb)."""
    from rkmh_tpu.commands.hash_cmd import HashConfig, run as hash_run
    from rkmh_tpu.commands.count_cmd import CountConfig, run as count_run
    from rkmh_tpu.commands.search_cmd import SearchConfig, run as search_run

    fq = tmp_path / "reads.fq"
    with open(fq, "w") as fh:
        for r in zika_reads[:30]:
            fh.write(f"@{r.name}\n{r.seq.decode()}\n+\n"
                     f"{(r.qual or b'I' * len(r.seq)).decode()}\n")

    # hash: all-hashes mode and sketch mode, odd batch size to force
    # rounding + padding
    for kw in ({"ks": (12,)}, {"ks": (12,), "sketch_size": 64}):
        base = run_cmd(HashConfig, hash_run, read_files=[str(fq)],
                       batch_size=7, **kw)
        sharded = run_cmd(HashConfig, hash_run, read_files=[str(fq)],
                          batch_size=7, devices=8, **kw)
        assert sharded == base

    # count --dump: lossy table must be bit-equal
    base = run_cmd(CountConfig, count_run, read_files=[str(fq)],
                   ks=(12,), counter_size=4096, dump=True, batch_size=7)
    sharded = run_cmd(CountConfig, count_run, read_files=[str(fq)],
                      ks=(12,), counter_size=4096, dump=True, batch_size=7,
                      devices=8)
    assert sharded == base

    # search: ref kmers from the first read
    reffile = tmp_path / "kmers.txt"
    seq = zika_reads[0].seq.decode()
    with open(reffile, "w") as fh:
        for i in range(0, 60, 3):
            fh.write(seq[i:i + 12] + " extra\n")
    base = run_cmd(SearchConfig, search_run, ref_files=[str(reffile)],
                   read_files=[str(fq)], ks=(12,), batch_size=7)
    sharded = run_cmd(SearchConfig, search_run, ref_files=[str(reffile)],
                      read_files=[str(fq)], ks=(12,), batch_size=7, devices=8)
    assert sharded == base


def test_hash_search_single_host_resume_byte_identical(tmp_path, zika_reads):
    """--resume on the single-host hash/search paths (round-5 ADVICE
    fix): a torn partial -o output resumes to bytes identical to an
    uninterrupted run — including search's short-read line skips (reads
    shorter than k emit nothing, so resume counts emitted LINES, not
    reads) and hash's native multi-line block writes."""
    import os

    from rkmh_tpu.commands.hash_cmd import HashConfig
    from rkmh_tpu.commands.hash_cmd import run as hash_run
    from rkmh_tpu.commands.search_cmd import SearchConfig
    from rkmh_tpu.commands.search_cmd import run as search_run

    fq = tmp_path / "mix.fq"
    with open(fq, "w") as fh:
        for i, r in enumerate(zika_reads[:30]):
            fh.write(f"@{r.name}\n{r.seq.decode()}\n+\n"
                     f"{(r.qual or b'I' * len(r.seq)).decode()}\n")
            if i % 5 == 0:  # short reads: search emits nothing for them
                fh.write(f"@short{i}\nACGTACG\n+\nIIIIIII\n")

    # hash: uninterrupted vs torn + resumed
    p = str(tmp_path / "hash.out")
    base = dict(read_files=[str(fq)], ks=(12,), batch_size=7, out_file=p)
    assert hash_run(HashConfig(**base)) == 0
    full = open(p).read()
    lines = full.splitlines(keepends=True)
    with open(p, "w") as fh:
        fh.writelines(lines[:11])
        fh.write("torn-tail-without-newline")
    assert hash_run(HashConfig(**base, resume=True)) == 0
    assert open(p).read() == full

    # resuming a COMPLETE run is a no-op append
    assert hash_run(HashConfig(**base, resume=True)) == 0
    assert open(p).read() == full

    # search
    reffile = tmp_path / "kmers.txt"
    seq = zika_reads[0].seq.decode()
    with open(reffile, "w") as fh:
        for i in range(0, 60, 3):
            fh.write(seq[i:i + 12] + "\n")
    ps = str(tmp_path / "search.out")
    sbase = dict(ref_files=[str(reffile)], read_files=[str(fq)], ks=(12,),
                 batch_size=7, out_file=ps)
    assert search_run(SearchConfig(**sbase)) == 0
    sfull = open(ps).read()
    slines = sfull.splitlines(keepends=True)
    assert len(slines) == 30  # short reads emitted nothing
    with open(ps, "w") as fh:
        fh.writelines(slines[:13])
    assert search_run(SearchConfig(**sbase, resume=True)) == 0
    assert open(ps).read() == sfull

    # --resume without -o refuses instead of silently restarting
    assert hash_run(HashConfig(read_files=[str(fq)], ks=(12,),
                               resume=True)) == 1
    assert search_run(SearchConfig(ref_files=[str(reffile)],
                                   read_files=[str(fq)], ks=(12,),
                                   resume=True)) == 1
    # ... and hash's non-line modes refuse too
    assert hash_run(HashConfig(read_files=[str(fq)], ks=(12,),
                               out_file=p, json_out=True, resume=True)) == 1
    assert os.path.getsize(p) > 0  # the refusal must not truncate
