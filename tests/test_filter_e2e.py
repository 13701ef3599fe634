"""End-to-end `filter` parity vs the shared scalar model of rkmh
main_filter (rkmh.cpp:996-1424 + equiv.hpp:324-353), on seeded
nanopore-length reads."""

import io

import numpy as np
import pytest

from rkmh_tpu import oracle, synth
from rkmh_tpu.commands.filter_cmd import FilterConfig, run

CTR = 100003  # small counter for tests (lossy modulo, like the reference's)


def oracle_filter(refs, reads, ks, s, min_diff=0, min_matches=-1,
                  min_kmer_occ=None, max_samples=None):
    return oracle.filter_records(refs, reads, ks, s, min_diff, min_matches,
                                 min_kmer_occ, max_samples, counter_size=CTR)


@pytest.fixture(scope="module")
def minion_data(tmp_path_factory):
    """Two references (an HPV16-length and a dengue-length genome) and 8
    long reads: six from the first reference at nanopore-like 8%
    substitution, two from an unrelated genome (they must fail)."""
    tmp = tmp_path_factory.mktemp("filter")
    rng = np.random.default_rng(25)
    refs = [synth.SeqRecord("hpv16_like", synth.to_bytes(synth.random_codes(rng, 7906))),
            synth.SeqRecord("dengue_like", synth.to_bytes(synth.random_codes(rng, 10723)))]
    other = synth.to_bytes(synth.random_codes(rng, 9000))
    kw = dict(mean_len=3000, sd_len=1500, min_len=800, sub_rate=0.08,
              n_run_frac=0.3)
    reads = next(synth.iter_reads(rng, [refs[0].seq], 6, prefix="m", **kw)) \
        + next(synth.iter_reads(rng, [other], 2, prefix="x", **kw))
    reads = [reads[i] for i in (0, 6, 1, 2, 7, 3, 4, 5)]
    rp, fp = str(tmp / "refs.fa"), str(tmp / "reads.fq")
    synth.write_fasta(rp, refs)
    synth.write_fastq(fp, reads)
    return refs, reads, rp, fp


def test_filter_basic(minion_data):
    refs, reads, rp, fp = minion_data
    ks, s = (16,), 400
    expected = oracle_filter(refs, reads, ks, s, min_matches=5)
    buf = io.StringIO()
    run(FilterConfig(ref_files=[rp], read_files=[fp], ks=ks, sketch_size=s,
                     min_matches=5, batch_size=8), out=buf)
    assert buf.getvalue() == expected
    assert expected  # some reads must actually pass for the test to bite


def test_filter_with_read_depth(minion_data):
    refs, reads, rp, fp = minion_data
    ks, s = (16,), 300
    expected = oracle_filter(refs, reads, ks, s, min_matches=2, min_kmer_occ=2)
    buf = io.StringIO()
    run(FilterConfig(ref_files=[rp], read_files=[fp], ks=ks, sketch_size=s,
                     min_matches=2, min_kmer_occ=2, counter_size=CTR,
                     batch_size=8), out=buf)
    assert buf.getvalue() == expected


def test_filter_informative_refs(minion_data):
    refs, reads, rp, fp = minion_data
    ks, s = (16,), 300
    expected = oracle_filter(refs, reads, ks, s, min_matches=2, max_samples=1)
    buf = io.StringIO()
    run(FilterConfig(ref_files=[rp], read_files=[fp], ks=ks, sketch_size=s,
                     min_matches=2, max_samples=1, counter_size=CTR,
                     batch_size=8), out=buf)
    assert buf.getvalue() == expected


def test_filter_stream_mode(minion_data):
    refs, reads, rp, fp = minion_data
    ks, s = (16,), 200
    fq = b"".join(
        b"@" + r.name.encode() + b"\n" + r.seq + b"\n+\n"
        + (r.qual or b"I" * len(r.seq)) + b"\n"
        for r in reads
    )
    buf = io.StringIO()
    run(FilterConfig(ref_files=[rp], ks=ks, sketch_size=s, in_stream=True,
                     batch_size=8), out=buf, stdin=io.BytesIO(fq))
    lines = buf.getvalue().splitlines()
    assert len(lines) == len(reads)
    # verify the first line against the scalar model
    ref_sk = [oracle.minhashes(oracle.calc_hashes(r.seq, list(ks)), s) for r in refs]
    sk = oracle.minhashes(oracle.calc_hashes(reads[0].seq, list(ks)), s)
    best, max_shared, prev, tu = "", 0, 0, 0
    for r, rs in zip(refs, ref_sk):
        shared = oracle.intersection_size(sk, rs)
        if shared > max_shared:
            prev = max_shared
            max_shared = shared
            best = r.name
            tu = min(len(sk), len(rs))
    exp = (f"Sample: {reads[0].name}\tResult: {best}\t{max_shared}\t{tu}\t"
           f"{''}\t{''}\t{'' if (max_shared - prev) > 0 else 'FAIL:DIFF'}")
    assert lines[0] == exp


def test_filter_devices_parity(minion_data, capsys):
    """--devices N [--tp T] output is byte-identical to single-device;
    -M and a non-dividing --tp warn and fall back."""
    refs, reads, rp, fp = minion_data
    ks, s = (16,), 400
    expected = oracle_filter(refs, reads, ks, s, min_matches=5)
    base = dict(ref_files=[rp], read_files=[fp], ks=ks, sketch_size=s,
                min_matches=5, batch_size=8)

    buf = io.StringIO()
    run(FilterConfig(**base, devices=4, tp=2), out=buf)
    assert buf.getvalue() == expected

    buf = io.StringIO()
    run(FilterConfig(**base, devices=8), out=buf)
    assert buf.getvalue() == expected
    capsys.readouterr()

    # -M with a dp-divisible counter: the depth counter shards over dp
    # and the lookup fuses into the SPMD step — identical to single-device
    dep = oracle_filter(refs, reads, ks, 300, min_matches=2, min_kmer_occ=2)
    mbase = dict(ref_files=[rp], read_files=[fp], ks=ks, sketch_size=300,
                 min_matches=2, min_kmer_occ=2, batch_size=8)
    buf = io.StringIO()
    run(FilterConfig(**mbase, counter_size=100_000, devices=4), out=buf)
    sd = io.StringIO()
    run(FilterConfig(**mbase, counter_size=100_000), out=sd)
    assert buf.getvalue() == sd.getvalue()
    capsys.readouterr()
    # -M whose counter size does not split over dp: warn + fallback
    buf = io.StringIO()
    run(FilterConfig(**mbase, counter_size=100_003, devices=4), out=buf)
    assert buf.getvalue() == dep
    assert "not divisible" in capsys.readouterr().err

    # tp does not divide the 2-ref panel: warn + fallback
    buf = io.StringIO()
    run(FilterConfig(**base, devices=6, tp=3), out=buf)
    assert buf.getvalue() == expected
    assert "does not divide" in capsys.readouterr().err


def test_filter_devices_stream_mode(minion_data):
    """--devices also covers the -i STDIN path (same classify closure)."""
    refs, reads, rp, fp = minion_data
    ks, s = (16,), 400
    with open(fp, "rb") as fh:
        payload = fh.read()
    single, sharded = io.StringIO(), io.StringIO()
    run(FilterConfig(ref_files=[rp], ks=ks, sketch_size=s, in_stream=True,
                     min_matches=5, batch_size=8),
        out=single, stdin=io.BytesIO(payload))
    run(FilterConfig(ref_files=[rp], ks=ks, sketch_size=s, in_stream=True,
                     min_matches=5, batch_size=8, devices=4, tp=2),
        out=sharded, stdin=io.BytesIO(payload))
    assert sharded.getvalue() == single.getvalue()
    assert "Sample:" in single.getvalue()
