"""hpv16 tiered classifier vs a scalar oracle on a synthetic refpath,
plus sorted-panel op checks and a real-data smoke test."""

import io
import os

import numpy as np
import pytest

from rkmh_tpu import oracle

DATA = "/root/reference/data"


# ---------------------------------------------------------------------------
# sorted panel op
# ---------------------------------------------------------------------------

def test_sorted_panel_distinct_counts():
    import jax.numpy as jnp
    from rkmh_tpu.ops.lookup import build_sorted_panel, sorted_panel_counts
    from rkmh_tpu.ops.sketch import SENTINEL

    rng = np.random.default_rng(3)
    rows = [np.unique(rng.integers(1, 60, size=30).astype(np.uint64)) for _ in range(5)]
    keys, masks = build_sorted_panel(rows)

    # queries: sorted arrays with duplicates + sentinel padding
    q = np.sort(rng.integers(1, 60, size=(4, 20)).astype(np.uint64), axis=-1)
    lens = np.array([20, 15, 7, 0], dtype=np.int32)
    qpad = q.copy()
    for b in range(4):
        qpad[b, lens[b]:] = SENTINEL

    got = np.asarray(
        sorted_panel_counts(jnp.asarray(qpad), jnp.asarray(lens),
                            jnp.asarray(keys), jnp.asarray(masks), 5)
    )
    for b in range(4):
        qset = set(qpad[b, : lens[b]].tolist())
        for r in range(5):
            assert got[b, r] == len(qset & set(rows[r].tolist()))


# ---------------------------------------------------------------------------
# synthetic refpath oracle parity
# ---------------------------------------------------------------------------

def _rand_seq(rng, n):
    return bytes(rng.choice(list(b"ACGT"), size=n).tolist())


def _mut(seq, positions, rng):
    s = bytearray(seq)
    for p in positions:
        cur = s[p]
        s[p] = rng.choice([b for b in b"ACGT" if b != cur])
    return bytes(s)


@pytest.fixture(scope="module")
def refpath(tmp_path_factory):
    """Synthetic PAVE panel (6 types) + 6 sublineage genomes (A1,A2,B1,
    B2,C1,D1) derived from type 0 with distinct mutation sets."""
    rng = np.random.default_rng(11)
    td = tmp_path_factory.mktemp("hpvdata")
    types = [_rand_seq(rng, 900) for _ in range(6)]
    with open(td / "all_pave_ref.fa", "w") as fh:
        for i, s in enumerate(types):
            fh.write(f">TYPE{i}REF extra comment\n{s.decode()}\n")

    base = types[0]
    subs = {}
    for name in ("A1", "A2", "B1", "B2", "C1", "D1"):
        positions = rng.choice(len(base) - 1, size=14, replace=False)
        subs[name] = _mut(base, positions, rng)
    with open(td / "new_refs.fa", "w") as fh:
        for name, s in subs.items():
            fh.write(f">{name} some description\n{s.decode()}\n")

    reads = []
    # reads drawn from A1 and D1 sublineages + one from type 3
    for i in range(6):
        s = int(rng.integers(0, 700))
        reads.append((f"readA1_{i}", subs["A1"][s : s + 200]))
    for i in range(4):
        s = int(rng.integers(0, 700))
        reads.append((f"readD1_{i}", subs["D1"][s : s + 200]))
    reads.append(("readT3", types[3][100:300]))
    fq = td / "reads.fq"
    with open(fq, "w") as fh:
        for name, s in reads:
            fh.write(f"@{name}\n{s.decode()}\n+\n{'I' * len(s)}\n")
    return td, types, subs, reads


def _oracle_hpv16_lines(types, subs, reads, k):
    """The shared hpv16 oracle over this module's fixture layout: type
    genomes named TYPE<i>REF in order, sublineages keyed by name."""
    from rkmh_tpu.io.fastx import SeqRecord

    return oracle.hpv16_lines(
        [SeqRecord(f"TYPE{i}REF", t) for i, t in enumerate(types)],
        [SeqRecord(n, sq) for n, sq in subs.items()],
        [SeqRecord(n, sq) for n, sq in reads], k)


def test_hpv16_matches_oracle(refpath, tmp_path, monkeypatch):
    from rkmh_tpu.commands.hpv16_cmd import Hpv16Config, run

    td, types, subs, reads = refpath
    monkeypatch.chdir(tmp_path)  # .tst side-effect file lands here
    buf = io.StringIO()
    rc = run(
        Hpv16Config(read_files=[str(td / "reads.fq")], refpath=str(td), ks=(16,)),
        out=buf,
    )
    assert rc == 0
    got = buf.getvalue().splitlines()
    want = _oracle_hpv16_lines(types, subs, reads, 16)
    assert got == want

    # side-effect parity: lineage table file written to CWD
    tst = tmp_path / "lineage_specific_hashes.16.tst"
    assert tst.exists()
    lines = tst.read_text().splitlines()
    assert [l.split("\t")[0] for l in lines] == ["A", "B", "C", "D"]
    assert all(l.endswith("\t") for l in lines)

    # classification sanity: A1 reads -> type 0, top sublineage A1
    for line in got[:6]:
        f = line.split("\t")
        assert f[1] == "TYPE0REF"
        assert f[4].startswith("A1:")
    assert got[10].split("\t")[1] == "TYPE3REF"


@pytest.mark.parametrize("seed", [21, 22])
def test_hpv16_fuzz_matches_oracle(tmp_path, monkeypatch, seed):
    """Randomized panel shapes + messy reads (Ns, sub-k, pure noise)
    against the scalar hpv16 oracle — tie-heavy sims exercise the
    sort_by_similarity ordering contract."""
    from rkmh_tpu.commands.hpv16_cmd import Hpv16Config, run

    rng = np.random.default_rng(seed)
    monkeypatch.chdir(tmp_path)
    n_types = int(rng.integers(3, 8))
    types = [_rand_seq(rng, int(rng.integers(300, 1200))) for _ in range(n_types)]
    with open(tmp_path / "all_pave_ref.fa", "w") as fh:
        for i, s in enumerate(types):
            fh.write(f">TYPE{i}REF\n{s.decode()}\n")
    base = types[0]
    sub_names = ["A1", "A2", "B1", "C1"][: int(rng.integers(2, 5))]
    subs = {}
    for name in sub_names:
        positions = rng.choice(len(base) - 1,
                               size=int(rng.integers(4, 20)), replace=False)
        subs[name] = _mut(base, positions, rng)
    with open(tmp_path / "new_refs.fa", "w") as fh:
        for name, s in subs.items():
            fh.write(f">{name}\n{s.decode()}\n")

    reads = []
    for i in range(18):
        kind = i % 4
        if kind == 0:   # sublineage slice
            src = subs[sub_names[i % len(subs)]]
        elif kind == 1:  # type slice
            src = types[i % len(types)]
        elif kind == 2:  # pure noise
            src = _rand_seq(rng, 120)
        else:           # slice with an N planted
            src = types[0]
        rl = int(rng.integers(8, 200))  # includes sub-k reads
        s0 = int(rng.integers(0, max(1, len(src) - rl)))
        sq = src[s0 : s0 + rl]
        if kind == 3 and len(sq) > 2:
            b = bytearray(sq)
            b[int(rng.integers(0, len(b)))] = ord("N")
            sq = bytes(b)
        reads.append((f"r{i}", sq))
    with open(tmp_path / "reads.fq", "w") as fh:
        for name, sq in reads:
            fh.write(f"@{name}\n{sq.decode()}\n+\n{'I' * len(sq)}\n")

    buf = io.StringIO()
    rc = run(
        Hpv16Config(read_files=[str(tmp_path / "reads.fq")],
                    refpath=str(tmp_path), ks=(16,), batch_size=8),
        out=buf,
    )
    assert rc == 0
    assert buf.getvalue().splitlines() == _oracle_hpv16_lines(
        types, subs, reads, 16)

    # random sharded geometry (round-5 combined-table split dispatch,
    # mesh.ShardedHpv16Comb): --devices [--tp] [-M] must stay
    # byte-identical to the oracle-pinned single-device run
    devices = int(rng.choice([2, 4, 8]))
    tp = int(rng.choice([t for t in (1, 2, 4) if devices % t == 0]))
    extra = {}
    if seed % 2:
        extra = dict(min_kmer_occ=2, counter_size=int(rng.choice(
            [4096, 4104, 65536])))
    sh = io.StringIO()
    assert run(
        Hpv16Config(read_files=[str(tmp_path / "reads.fq")],
                    refpath=str(tmp_path), ks=(16,), batch_size=8,
                    devices=devices, tp=tp, tst_file=False, **extra),
        out=sh,
    ) == 0
    if extra:  # -M changes results vs plain: recompute the single ref
        one = io.StringIO()
        assert run(
            Hpv16Config(read_files=[str(tmp_path / "reads.fq")],
                        refpath=str(tmp_path), ks=(16,), batch_size=8,
                        tst_file=False, **extra),
            out=one,
        ) == 0
        assert sh.getvalue() == one.getvalue(), (devices, tp, extra)
    else:
        assert sh.getvalue() == buf.getvalue(), (devices, tp)


def test_hpv16_min_kmer_occ(refpath, tmp_path, monkeypatch):
    """-M with a huge threshold masks every hash -> all intersections 0."""
    from rkmh_tpu.commands.hpv16_cmd import Hpv16Config, run

    td, types, subs, reads = refpath
    monkeypatch.chdir(tmp_path)
    buf = io.StringIO()
    run(
        Hpv16Config(read_files=[str(td / "reads.fq")], refpath=str(td),
                    ks=(16,), min_kmer_occ=10_000, counter_size=1 << 20),
        out=buf,
    )
    for line in buf.getvalue().splitlines():
        f = line.split("\t")
        assert f[1] == "TYPE0REF" and f[2].startswith("0/")
        assert all(int(c) == 0 for c in f[5].split(";") if c)


def test_hpv16_resume_after_injected_failure(refpath, tmp_path, monkeypatch):
    """hpv16 emits one line per read, so --resume is line-counted (like
    stream): crash mid-run via fault injection, resume, byte-identical."""
    from rkmh_tpu.commands.hpv16_cmd import Hpv16Config, run
    from rkmh_tpu.commands.recovery import InjectedFailure

    td, types, subs, reads = refpath
    monkeypatch.chdir(tmp_path)

    def cfg(out_file="", resume=False):
        return Hpv16Config(read_files=[str(td / "reads.fq")], refpath=str(td),
                           ks=(16,), chunk_reads=3,
                           out_file=out_file, resume=resume)

    golden = tmp_path / "golden.out"
    assert run(cfg(out_file=str(golden))) == 0
    full = golden.read_text()

    part = tmp_path / "part.out"
    monkeypatch.setenv("RKMH_TPU_FAIL_AFTER_CHUNKS", "2")
    with pytest.raises(InjectedFailure):
        run(cfg(out_file=str(part)))
    monkeypatch.delenv("RKMH_TPU_FAIL_AFTER_CHUNKS")
    assert 0 < len(part.read_text()) < len(full)  # it really died mid-run

    assert run(cfg(out_file=str(part), resume=True)) == 0
    assert part.read_text() == full

    # --resume needs -o
    assert run(cfg(resume=True)) == 1


@pytest.mark.slow
def test_hpv16_real_data_smoke(tmp_path, monkeypatch):
    """Real PAVE panel + minION reads: format + type plausibility."""
    from rkmh_tpu.commands.hpv16_cmd import Hpv16Config, run

    monkeypatch.chdir(tmp_path)
    # subset of minION reads to keep runtime bounded
    from rkmh_tpu.io.fastx import read_fastx

    reads = read_fastx(f"{DATA}/minION25.fq")[:6]
    fq = tmp_path / "m.fq"
    with open(fq, "w") as fh:
        for r in reads:
            fh.write(f"@{r.name}\n{r.seq.decode()}\n+\n{(r.qual or b'I'*len(r.seq)).decode()}\n")

    buf = io.StringIO()
    rc = run(
        Hpv16Config(read_files=[str(fq)], refpath=DATA, ks=(16,), batch_size=8),
        out=buf,
    )
    assert rc == 0
    lines = buf.getvalue().splitlines()
    assert len(lines) == 6
    for line in lines:
        f = line.split("\t")
        assert len(f) == 7
        assert f[3].count(";") == 4 and f[4].count(";") == 10  # 4 lins, 10 sublins
        # minION reads are HPV16 — the type step should say so
        assert "HPV16" in f[1]


def test_hpv16_devices_parity(refpath, tmp_path, monkeypatch):
    """--devices N (dp-sharded reads, replicated set tables) is
    byte-identical to the single-device run; invalid device counts warn
    and fall back."""
    from rkmh_tpu.commands.hpv16_cmd import Hpv16Config, run

    td, types, subs, reads = refpath
    monkeypatch.chdir(tmp_path)
    base = dict(read_files=[str(td / "reads.fq")], refpath=str(td),
                ks=(16,), batch_size=8)

    single = io.StringIO()
    assert run(Hpv16Config(**base), out=single) == 0
    sharded = io.StringIO()
    assert run(Hpv16Config(**base, devices=4), out=sharded) == 0
    assert sharded.getvalue() == single.getvalue()

    # more devices than visible: warn + single-device output
    fallback = io.StringIO()
    assert run(Hpv16Config(**base, devices=64), out=fallback) == 0
    assert fallback.getvalue() == single.getvalue()


def test_hpv16_devices_min_kmer_occ_parity(refpath, tmp_path, monkeypatch):
    """--devices with -M: the read-depth counter shards over dp and the
    mask fuses into the SPMD step — byte-identical to single-device."""
    from rkmh_tpu.commands.hpv16_cmd import Hpv16Config, run

    td, types, subs, reads = refpath
    monkeypatch.chdir(tmp_path)
    base = dict(read_files=[str(td / "reads.fq")], refpath=str(td),
                ks=(16,), batch_size=8, min_kmer_occ=2, counter_size=4096)
    single = io.StringIO()
    assert run(Hpv16Config(**base), out=single) == 0
    sharded = io.StringIO()
    assert run(Hpv16Config(**base, devices=4), out=sharded) == 0
    assert sharded.getvalue() == single.getvalue()


def test_hpv16_dist_drain_matches_single(refpath, tmp_path, monkeypatch):
    """The hpv16 lockstep distributed drain (single process over the
    8-device mesh — the multi-rank mechanics are covered by the CLI test
    in test_distributed.py) is byte-identical to the normal driver,
    with and without -M."""
    from rkmh_tpu.commands.dist_stream import run_distributed_hpv16
    from rkmh_tpu.commands.hpv16_cmd import Hpv16Config, run

    td, types, subs, reads = refpath
    monkeypatch.chdir(tmp_path)
    for extra in ({}, {"min_kmer_occ": 2, "counter_size": 4096}):
        base = dict(read_files=[str(td / "reads.fq")], refpath=str(td),
                    ks=(16,), batch_size=8, **extra)
        single = io.StringIO()
        assert run(Hpv16Config(**base), out=single) == 0
        dist = io.StringIO()
        assert run_distributed_hpv16(Hpv16Config(**base), out=dist) == 0
        assert dist.getvalue() == single.getvalue(), extra


def test_hpv16_devices_tp_parity(refpath, tmp_path, monkeypatch):
    """--devices with --tp: the type set table shards over the tp axis
    (padded to a tp multiple with all-masked rows when needed) and the
    gathered distinct counts keep the exact argmax — byte-identical."""
    from rkmh_tpu.commands.hpv16_cmd import Hpv16Config, run

    td, types, subs, reads = refpath
    monkeypatch.chdir(tmp_path)
    base = dict(read_files=[str(td / "reads.fq")], refpath=str(td),
                ks=(16,), batch_size=8)
    single = io.StringIO()
    assert run(Hpv16Config(**base), out=single) == 0
    # the synthetic type panel has len(types) refs; tp=2 forces the
    # padded path whenever it is odd
    for devices, tp in ((4, 2), (8, 4)):
        sharded = io.StringIO()
        assert run(Hpv16Config(**base, devices=devices, tp=tp),
                   out=sharded) == 0
        assert sharded.getvalue() == single.getvalue(), (devices, tp)
