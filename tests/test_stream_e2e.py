"""End-to-end `stream`/`classify` parity on seeded zika-shaped data.

Expected output comes from the shared oracle (rkmh_tpu.oracle.stream_lines),
a pure numpy/Python pipeline that mirrors rkmh main_stream's exact
semantics (rkmh.cpp:845-898): bottom-s sketches, min-multiplicity sorted
intersection, scan-argmax starting at -1 with strict >, and the FAIL-tag
line format of rkmh.cpp:892.
"""

import io

import numpy as np
import pytest

from rkmh_tpu import oracle, synth
from rkmh_tpu.commands.stream import StreamConfig, run


def oracle_stream_lines(refs, reads, ks, s, **kw):
    return "".join(oracle.stream_lines(refs, reads, ks, s, **kw))


write_fasta = synth.write_fasta
write_fastq = synth.write_fastq


def zika_like(seed, n_refs=5, ref_len=2000, n_reads=16, read_len=150):
    """A small seeded strain panel and reads drawn from it (1% subs, some
    reads with an N run)."""
    rng = np.random.default_rng(seed)
    refs = synth.zika_panel(rng, n_refs, ref_len)
    reads = next(synth.iter_reads(rng, [r.seq for r in refs], n_reads,
                                  length=read_len, sub_rate=0.01,
                                  n_run_frac=0.2, prefix="z"))
    return refs, reads


@pytest.fixture(scope="module")
def zika_subset(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("zika")
    refs, reads = zika_like(5)
    rp, fp = str(tmp / "refs.fa"), str(tmp / "reads.fq")
    write_fasta(rp, refs)
    write_fastq(fp, reads)
    return refs, reads, rp, fp


def test_stream_matches_oracle_zika(zika_subset):
    refs, reads, rp, fp = zika_subset
    ks, s = (12,), 1000
    expected = oracle_stream_lines(refs, reads, ks, s)
    buf = io.StringIO()
    run(StreamConfig(ref_files=[rp], read_files=[fp], ks=ks, sketch_size=s,
                     batch_size=8), out=buf)
    assert buf.getvalue() == expected


def test_stream_long_reads_mixed_grid_matches_oracle(tmp_path):
    """z1_long (1500 bp) + z1 (150 bp) in one run: reads straddle the
    fine-32 / coarse-128 padded-length grids (io.packing.grid_length),
    so batches come from different buckets and must still reassemble in
    input order, byte-identical to the oracle."""
    refs, short = zika_like(6, read_len=150, n_reads=8)
    _, long_ = zika_like(6, read_len=1500, n_reads=8)
    reads = long_ + short
    # interleave so bucket emission order differs from input order
    reads = [r for pair in zip(reads[:8], reads[8:]) for r in pair]
    rp, fp = str(tmp_path / "refs.fa"), str(tmp_path / "reads.fq")
    write_fasta(rp, refs)
    write_fastq(fp, reads)
    ks, s = (12,), 1000
    expected = oracle_stream_lines(refs, reads, ks, s)
    buf = io.StringIO()
    run(StreamConfig(ref_files=[rp], read_files=[fp], ks=ks, sketch_size=s,
                     batch_size=4), out=buf)
    assert buf.getvalue() == expected


def test_stream_with_filters_matches_oracle(zika_subset):
    refs, reads, rp, fp = zika_subset
    ks, s = (12,), 200
    expected = oracle_stream_lines(refs, reads, ks, s, min_diff=3, min_matches=20)
    buf = io.StringIO()
    run(StreamConfig(ref_files=[rp], read_files=[fp], ks=ks, sketch_size=s,
                     min_diff=3, min_matches=20, batch_size=16), out=buf)
    assert buf.getvalue() == expected


def test_stream_multi_k(zika_subset):
    refs, reads, rp, fp = zika_subset
    ks, s = (12, 14), 300
    expected = oracle_stream_lines(refs, reads, ks, s)
    buf = io.StringIO()
    run(StreamConfig(ref_files=[rp], read_files=[fp], ks=ks, sketch_size=s,
                     batch_size=16), out=buf)
    assert buf.getvalue() == expected


def test_stream_min_kmer_occ_matches_oracle(zika_subset):
    """-M: global lossy read-depth counting then depth-masked sketches
    (rkmh.cpp:903-917), small counter to exercise collision semantics."""
    refs, reads, rp, fp = zika_subset
    ks, s, M, C = (12,), 200, 2, 4096
    expected = oracle_stream_lines(refs, reads, ks, s, min_kmer_occ=M,
                                   counter_size=C)

    buf = io.StringIO()
    run(StreamConfig(ref_files=[rp], read_files=[fp], ks=ks, sketch_size=s,
                     min_kmer_occ=M, counter_size=C, batch_size=8), out=buf)
    assert buf.getvalue() == expected


def test_stream_max_samples_matches_oracle(zika_subset):
    """-I: reference k-mers counted (every occurrence) in the lossy table;
    ref sketches keep only hashes with count <= max_samples
    (rkmh.cpp:828-837)."""
    refs, reads, rp, fp = zika_subset
    ks, s, I, C = (12,), 200, 3, 1 << 16
    expected = oracle_stream_lines(refs, reads, ks, s, max_samples=I,
                                   counter_size=C)

    buf = io.StringIO()
    run(StreamConfig(ref_files=[rp], read_files=[fp], ks=ks, sketch_size=s,
                     max_samples=I, counter_size=C, batch_size=8), out=buf)
    assert buf.getvalue() == expected


def test_stream_in_stream_matches_file_mode(zika_subset):
    """stream -i: STDIN classification, flushed per batch, byte-identical
    to file mode (the reference parses -i for stream but the path is
    dead, rkmh.cpp:608/710 — implemented for real here)."""
    refs, reads, rp, fp = zika_subset
    ks, s = (12,), 1000
    expected = oracle_stream_lines(refs, reads, ks, s)
    buf = io.StringIO()
    run(StreamConfig(ref_files=[rp], ks=ks, sketch_size=s, in_stream=True,
                     batch_size=8), out=buf, stdin=io.BytesIO(open(fp, "rb").read()))
    assert buf.getvalue() == expected


def test_stream_in_stream_with_M_buffers(zika_subset):
    """stream -i -M falls back to the buffered two-pass path (a stream
    cannot be re-read) and still byte-matches file mode."""
    refs, reads, rp, fp = zika_subset
    ks, s, M, C = (12,), 200, 2, 4096
    file_buf = io.StringIO()
    run(StreamConfig(ref_files=[rp], read_files=[fp], ks=ks, sketch_size=s,
                     min_kmer_occ=M, counter_size=C, batch_size=8), out=file_buf)
    buf = io.StringIO()
    run(StreamConfig(ref_files=[rp], ks=ks, sketch_size=s, in_stream=True,
                     min_kmer_occ=M, counter_size=C, batch_size=8),
        out=buf, stdin=io.BytesIO(open(fp, "rb").read()))
    assert buf.getvalue() == file_buf.getvalue()


def test_stream_in_stream_resume_refused(zika_subset):
    refs, reads, rp, fp = zika_subset
    buf = io.StringIO()
    rc = run(StreamConfig(ref_files=[rp], ks=(12,), in_stream=True,
                          resume=True, out_file="/tmp/nonexistent-out.rk"),
             out=buf, stdin=io.BytesIO(b""))
    assert rc == 1


def test_stream_in_stream_propagates_parse_errors(zika_subset):
    """A malformed record mid-stream must raise, not silently truncate
    (the reader thread forwards its exception to the consumer)."""
    refs, reads, rp, fp = zika_subset
    bad = (b"@r1\nACGTACGTACGTACGT\n+\nIIIIIIIIIIIIIIII\n"
           b"not a fastq line\n")
    with pytest.raises(ValueError):
        run(StreamConfig(ref_files=[rp], ks=(12,), in_stream=True,
                         batch_size=8),
            out=io.StringIO(), stdin=io.BytesIO(bad))


def test_stream_i_with_f_prefers_files(zika_subset):
    """`stream -f reads.fq -i` classifies the files (reference parity:
    rkmh's -i is dead, so -f always won there) instead of blocking on
    stdin."""
    refs, reads, rp, fp = zika_subset
    ks, s = (12,), 1000
    expected = oracle_stream_lines(refs, reads, ks, s)
    buf = io.StringIO()
    run(StreamConfig(ref_files=[rp], read_files=[fp], ks=ks, sketch_size=s,
                     in_stream=True, batch_size=8),
        out=buf, stdin=io.BytesIO(b""))
    assert buf.getvalue() == expected


def test_stream_in_stream_metrics_and_peak(zika_subset):
    """--metrics counters and the peak-buffered-lines observability are
    live for -i runs too."""
    from rkmh_tpu import observability
    from rkmh_tpu.commands import stream as stream_mod

    refs, reads, rp, fp = zika_subset
    observability.COUNTERS.clear()
    buf = io.StringIO()
    run(StreamConfig(ref_files=[rp], ks=(12,), sketch_size=1000,
                     in_stream=True, batch_size=8),
        out=buf, stdin=io.BytesIO(open(fp, "rb").read()))
    assert observability.COUNTERS["reads"] == len(reads)
    assert observability.COUNTERS["bp"] == sum(len(r.seq) for r in reads)
    assert 0 < stream_mod.last_peak_buffered_lines <= 3 * 8


def test_stream_in_stream_flushes_on_idle(zika_subset):
    """Live-source liveness: when input stalls (tail -f style), already
    read records are classified and written without waiting for EOF."""
    import threading

    refs, reads, rp, fp = zika_subset
    split = 3

    def fq(rs):
        return b"".join(
            b"@" + r.name.encode() + b"\n" + r.seq + b"\n+\n"
            + (r.qual or b"I" * len(r.seq)) + b"\n"
            for r in rs
        )

    part1, part2 = fq(reads[:split]), fq(reads[split:])
    released = threading.Event()

    class StallingSource:
        """Yields part1, then blocks until output appears, then part2."""

        def __init__(self):
            self.buf = io.BytesIO(part1)
            self.stalled = False

        def readline(self):
            line = self.buf.readline()
            if line:
                return line
            if not self.stalled:
                self.stalled = True
                assert released.wait(60), "no output while input stalled"
                self.buf = io.BytesIO(part2)
                return self.buf.readline()
            return b""

    class SignalOut(io.StringIO):
        def write(self, s):
            if s:
                released.set()
            return super().write(s)

    out = SignalOut()
    t = threading.Thread(
        target=run,
        args=(StreamConfig(ref_files=[rp], ks=(12,), sketch_size=1000,
                           in_stream=True, batch_size=8),),
        kwargs=dict(out=out, stdin=StallingSource()),
        daemon=True,
    )
    t.start()
    t.join(120)
    assert not t.is_alive(), "stream -i deadlocked on a stalled source"
    assert released.is_set()
    expected = oracle_stream_lines(refs, reads, (12,), 1000)
    assert out.getvalue() == expected


# ---- --devices: SPMD classify at the CLI surface (parallel/mesh.py) ----
# zika_subset has 5 refs: tp must be 1 or 5; a 4-ref panel covers tp=2.


def _stream_out(cfg_kwargs):
    buf = io.StringIO()
    rc = run(StreamConfig(**cfg_kwargs), out=buf)
    assert rc == 0
    return buf.getvalue()


def test_stream_devices_dp_parity(zika_subset):
    refs, reads, rp, fp = zika_subset
    base = dict(ref_files=[rp], read_files=[fp], ks=(12,), sketch_size=1000,
                batch_size=8)
    expected = oracle_stream_lines(refs, reads, (12,), 1000)
    single = _stream_out(base)
    assert single == expected
    sharded = _stream_out({**base, "devices": 4})
    assert sharded == expected


def test_stream_devices_dp_tp_parity(zika_subset, tmp_path):
    refs, reads, rp, fp = zika_subset
    refs4 = refs[:4]
    rp4 = str(tmp_path / "refs4.fa")
    write_fasta(rp4, refs4)
    base = dict(ref_files=[rp4], read_files=[fp], ks=(12,), sketch_size=1000,
                batch_size=8)
    expected = oracle_stream_lines(refs4, reads, (12,), 1000)
    sharded = _stream_out({**base, "devices": 4, "tp": 2})
    assert sharded == expected
    full_tp = _stream_out({**base, "devices": 8, "tp": 4})
    assert full_tp == expected


def test_stream_devices_fallbacks(zika_subset, capsys):
    refs, reads, rp, fp = zika_subset
    base = dict(ref_files=[rp], read_files=[fp], ks=(12,), sketch_size=1000,
                batch_size=8)
    expected = oracle_stream_lines(refs, reads, (12,), 1000)
    # tp=2 does not divide the 5-ref panel: warn + single-device output
    out = _stream_out({**base, "devices": 4, "tp": 2})
    assert out == expected
    assert "does not divide" in capsys.readouterr().err
    # -M whose counter size does not split over dp: warn + single-device
    out = _stream_out({**base, "devices": 4, "min_kmer_occ": 0,
                       "counter_size": 100003})
    assert out == oracle_stream_lines(refs, reads, (12,), 1000)
    assert "not divisible" in capsys.readouterr().err
    # more devices than visible: warn + single-device output
    out = _stream_out({**base, "devices": 64})
    assert out == expected
    assert "visible device" in capsys.readouterr().err


def test_stream_devices_min_kmer_occ_parity(zika_subset, tmp_path):
    """--devices with -M: the depth counter shards over dp
    (parallel/ep.py) and the lookup fuses into the sharded classify
    step — byte-identical to the single-device two-pass -M run, with a
    small collision-prone counter to stress the lossy-modulo parity."""
    refs, reads, rp, fp = zika_subset
    base = dict(ref_files=[rp], read_files=[fp], ks=(12,), sketch_size=1000,
                batch_size=8, min_kmer_occ=2, counter_size=100_000)
    single = _stream_out(base)
    for devices in (4, 8):
        assert _stream_out({**base, "devices": devices}) == single, devices
    # and with tp-sharded tables on a 4-ref panel
    rp4 = str(tmp_path / "refs4.fa")
    write_fasta(rp4, refs[:4])
    base4 = {**base, "ref_files": [rp4]}
    assert (_stream_out({**base4, "devices": 8, "tp": 2})
            == _stream_out(base4))


def test_stream_in_stream_devices_parity(zika_subset):
    """stream -i --devices: the live-STDIN drain dispatches the SPMD
    step per batch; output is byte-identical to single-device -i."""
    refs, reads, rp, fp = zika_subset
    payload = open(fp, "rb").read()
    base = dict(ref_files=[rp], ks=(12,), sketch_size=1000,
                in_stream=True, batch_size=8)
    one, two = io.StringIO(), io.StringIO()
    assert run(StreamConfig(**base), out=one,
               stdin=io.BytesIO(payload)) == 0
    assert run(StreamConfig(**base, devices=4), out=two,
               stdin=io.BytesIO(payload)) == 0
    assert two.getvalue() == one.getvalue()
    assert one.getvalue() == oracle_stream_lines(refs, reads, (12,), 1000)
