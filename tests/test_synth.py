"""The seeded input generator shared by the tests and chip_smoke.py."""

import numpy as np

from rkmh_tpu import oracle, synth
from rkmh_tpu.io.fastx import read_fastx


def test_same_seed_same_bytes():
    def make(seed):
        rng = np.random.default_rng(seed)
        refs = synth.zika_panel(rng, 4, 500)
        reads = next(synth.iter_reads(rng, [r.seq for r in refs], 50,
                                      length=150, sub_rate=0.01,
                                      n_run_frac=0.5))
        return [r.seq for r in refs] + [r.seq for r in reads]

    assert make(3) == make(3)
    assert make(3) != make(4)


def test_zika_panel_and_read_shapes():
    rng = np.random.default_rng(0)
    refs = synth.zika_panel(rng)
    assert len(refs) == 60 and {len(r.seq) for r in refs} == {10_794}
    chunks = list(synth.iter_reads(rng, [r.seq for r in refs], 1000,
                                   length=150, sub_rate=0.01,
                                   n_run_frac=0.1, chunk=300))
    assert [len(c) for c in chunks] == [300, 300, 300, 100]
    reads = [r for c in chunks for r in c]
    assert {len(r.seq) for r in reads} == {150}
    assert [r.name for r in reads] == [f"read{i}" for i in range(1000)]
    with_n = sum(b"N" in r.seq for r in reads)
    assert 50 < with_n < 150  # ~10% carry an N run


def test_long_read_lengths_and_substitution_rate():
    rng = np.random.default_rng(1)
    genome = synth.to_bytes(synth.random_codes(rng, 7906))
    reads = next(synth.iter_reads(rng, [genome], 400, mean_len=4500,
                                  sd_len=1200, min_len=1000, sub_rate=0.05))
    lens = np.array([len(r.seq) for r in reads])
    assert 4200 < lens.mean() < 4800 and lens.min() >= 1000
    assert lens.max() <= 7906
    # windows that survive 5% substitution: ~(0.95)^16 of 16-mers
    g = set(oracle.calc_hashes_np(genome, 16).tolist())
    h = oracle.calc_hashes_np(reads[0].seq, 16)
    assert 0.3 < np.isin(h, list(g)).mean() < 0.6


def test_hpv_refpath_layout(tmp_path):
    rng = np.random.default_rng(2)
    types, subs = synth.hpv_refpath(tmp_path, rng)
    assert len(types) == 182 and types[15].name == "HPV16REF"
    assert [s.name for s in subs] == list(synth.HPV16_SUBLINEAGES)
    assert [r.name for r in read_fastx(str(tmp_path / "all_pave_ref.fa"))] \
        == [t.name for t in types]
    assert [r.seq for r in read_fastx(str(tmp_path / "new_refs.fa"))] \
        == [s.seq for s in subs]
    # sublineages sit ~1.5% from HPV16REF and ~0.5-1% from their lineage
    base = np.frombuffer(types[15].seq, np.uint8)
    div = [np.mean(np.frombuffer(s.seq, np.uint8) != base) for s in subs]
    assert all(0.008 < d < 0.025 for d in div)


def test_plant_snps_spacing():
    rng = np.random.default_rng(3)
    genome = synth.to_bytes(synth.random_codes(rng, 7906))
    mutated, pos = synth.plant_snps(genome, 20, rng)
    diff = np.nonzero(np.frombuffer(mutated, np.uint8)
                      != np.frombuffer(genome, np.uint8))[0]
    assert diff.tolist() == pos and len(pos) == 20
    assert min(np.diff(pos)) >= 40 and pos[0] >= 50 and pos[-1] < 7906 - 50
