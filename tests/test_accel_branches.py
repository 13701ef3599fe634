"""The accelerator-only branches of the classify step, run on the CPU.

engine.accel_branches() is the one switch for the sort-free occurrence
rank and the 2-bit packed input wire.  Tests drive both branches here by
passing accel=True to the jitted classify wrappers, or by patching the
switch so the commands take them end to end, and hold every output bit
for bit to the shared oracle.
"""

import io

import numpy as np
import pytest

from rkmh_tpu import oracle, synth
from rkmh_tpu.classify import engine


@pytest.fixture(scope="module")
def panel_and_reads(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("accel")
    rng = np.random.default_rng(31)
    refs = synth.zika_panel(rng, 6, 1500)
    reads = next(synth.iter_reads(rng, [r.seq for r in refs], 40, length=150,
                                  sub_rate=0.01, n_run_frac=0.25, prefix="a"))
    rp, fp = str(tmp / "refs.fa"), str(tmp / "reads.fq")
    synth.write_fasta(rp, refs)
    synth.write_fastq(fp, reads)
    return refs, reads, rp, fp


@pytest.fixture
def accel_on(monkeypatch):
    monkeypatch.setattr(engine, "accel_branches", lambda: True)


@pytest.mark.parametrize("W,s,accel,want", [
    (149, 1000, True, True),    # zika reads: every window fits the sketch
    (149, 1000, False, False),  # CPU backends keep the row sort
    (149, 100, True, False),    # W > s needs real bottom-s selection
    (300, 1000, True, False),   # past NOSORT_MAX_W the O(W^2) rank is off
])
def test_use_nosort_gate(W, s, accel, want):
    assert engine.use_nosort(W, s, accel) is want


def test_pack4_ok_follows_the_switch(accel_on):
    assert engine.pack4_ok(160)
    assert not engine.pack4_ok(150)  # not whole bytes of 2-bit codes


def test_pack4_ok_off_on_cpu():
    assert engine.accel_branches() is False
    assert not engine.pack4_ok(160)


def _batch(panel_and_reads, s):
    from rkmh_tpu.commands.common import build_ref_panel, load_packed
    from rkmh_tpu.io.packing import encode_seqs

    refs, reads, rp, _ = panel_and_reads
    panel = build_ref_panel(load_packed([rp]), (12,), s)
    codes, _ = encode_seqs([r.seq for r in reads], pad_to=160)
    return panel, codes


def _lines(panel, reads, arr, s):
    from rkmh_tpu.commands.stream import format_lines_host

    arr = engine.unpack2_host(np.asarray(arr), len(reads))
    return format_lines_host(panel.keys, [r.name for r in reads], arr, s,
                             as_list=True)


@pytest.mark.parametrize("s,min_matches", [(1000, -1), (1000, 30), (100, 5)])
def test_codes_wrapper_accel_matches_oracle(panel_and_reads, s, min_matches):
    """classify_codes_table_packed2 with accel=True (sort-free rank when
    W <= s) is bit-exact against the oracle."""
    refs, reads, _, _ = panel_and_reads
    panel, codes = _batch(panel_and_reads, s)
    arr = engine.classify_codes_table_packed2(
        codes, *panel.table, ks=(12,), sketch_size=s, num_refs=panel.num_refs,
        min_diff=0, min_matches=min_matches, accel=True)
    assert _lines(panel, reads, arr, s) == oracle.stream_lines(
        refs, reads, 12, s, min_matches=min_matches)


@pytest.mark.parametrize("s", [1000, 100])
def test_packed4_wrapper_accel_matches_oracle(panel_and_reads, s):
    """The 2-bit packed wire (pack_codes4 -> device unpack) feeding the
    accel step is bit-exact against the oracle, N runs included."""
    from rkmh_tpu.io.packing import pack_codes4

    refs, reads, _, _ = panel_and_reads
    panel, codes = _batch(panel_and_reads, s)
    pk, vb = pack_codes4(codes)
    arr = engine.classify_packed4_table_packed2(
        pk, vb, codes.shape[1], *panel.table, ks=(12,), sketch_size=s,
        num_refs=panel.num_refs, min_diff=0, min_matches=-1, accel=True)
    assert _lines(panel, reads, arr, s) == oracle.stream_lines(refs, reads, 12, s)


def test_three_row_wrapper_accel_matches_sort_path(panel_and_reads):
    panel, codes = _batch(panel_and_reads, 1000)
    kw = dict(ks=(12,), sketch_size=1000, num_refs=panel.num_refs,
              min_diff=0, min_matches=-1)
    a = engine.classify_codes_table_packed(codes, *panel.table, accel=True, **kw)
    b = engine.classify_codes_table_packed(codes, *panel.table, accel=False, **kw)
    assert np.array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("extra", [
    {},
    {"min_kmer_occ": 2, "counter_size": 4096},
    {"max_samples": 3, "counter_size": 1 << 16},
])
def test_stream_command_accel_matches_oracle(panel_and_reads, accel_on, extra):
    """`stream` with the switch on takes the packed wire (and the
    sort-free rank without -M) through the command driver."""
    from rkmh_tpu.commands.stream import StreamConfig, run

    refs, reads, rp, fp = panel_and_reads
    buf = io.StringIO()
    assert run(StreamConfig(ref_files=[rp], read_files=[fp], ks=(12,),
                            sketch_size=1000, batch_size=16, **extra),
               out=buf) == 0
    want = oracle.stream_lines(
        refs, reads, 12, 1000,
        min_kmer_occ=extra.get("min_kmer_occ"),
        max_samples=extra.get("max_samples"),
        counter_size=extra.get("counter_size", 200_000_000))
    assert buf.getvalue() == "".join(want)


def test_filter_command_accel_matches_oracle(panel_and_reads, accel_on):
    from rkmh_tpu.commands.filter_cmd import FilterConfig, run

    refs, reads, rp, fp = panel_and_reads
    buf = io.StringIO()
    assert run(FilterConfig(ref_files=[rp], read_files=[fp], ks=(12,),
                            sketch_size=200, min_matches=20, batch_size=16),
               out=buf) == 0
    want = oracle.filter_records(refs, reads, 12, 200, min_matches=20)
    assert buf.getvalue() == want and want


@pytest.mark.parametrize("extra", [{}, {"min_kmer_occ": 2, "counter_size": 4096}])
def test_hpv16_command_accel_matches_oracle(tmp_path, monkeypatch, accel_on, extra):
    from rkmh_tpu.commands.hpv16_cmd import Hpv16Config, run

    rng = np.random.default_rng(41)
    types, subs = synth.hpv_refpath(tmp_path / "ref", rng, n_types=16,
                                    type_len=900)
    src = [s.seq for s in subs] + [t.seq for t in types]
    reads = next(synth.iter_reads(rng, src, 20, mean_len=400, sd_len=150,
                                  min_len=20, sub_rate=0.03, n_run_frac=0.2,
                                  prefix="h"))
    synth.write_fastq(tmp_path / "reads.fq", reads)
    monkeypatch.chdir(tmp_path)
    buf = io.StringIO()
    assert run(Hpv16Config(read_files=[str(tmp_path / "reads.fq")],
                           refpath=str(tmp_path / "ref"), ks=(18,),
                           batch_size=8, **extra), out=buf) == 0
    want = oracle.hpv16_lines(types, subs, reads, 18,
                              min_kmer_occ=extra.get("min_kmer_occ", 0),
                              counter_size=extra.get("counter_size", 1))
    assert buf.getvalue().splitlines() == want
