"""Seeded synthetic genomes and reads at the shapes rkmh's users run.

Everything here is made from a numpy Generator, so a seed fixes every
byte; nothing is downloaded.  The shapes follow the BASELINE
configurations (BASELINE.md):

* zika panel: 60 strain genomes of 10,794 bp in a two-level tree (clades
  of close strains), Illumina-style 150 bp reads;
* HPV refpath: a PAVE-like panel of 182 type genomes of ~7,900 bp
  (``all_pave_ref.fa``) plus the 10 HPV16 sublineage genomes A1..D3
  (``new_refs.fa``) that ``hpv16`` reads from its -R directory, and
  nanopore-length reads (~4.5 kb) drawn from them;
* a call genome with planted SNPs.

Reads carry stated substitution rates and optional runs of ``N`` (the
invalid-base path every kernel masks).
"""

from __future__ import annotations

import os

import numpy as np

from rkmh_tpu.io.fastx import SeqRecord

_ASCII = np.frombuffer(b"ACGT", np.uint8)
_N = ord("N")

ZIKA_REFS, ZIKA_REF_LEN, ZIKA_READ_LEN = 60, 10_794, 150
HPV_TYPES, HPV_TYPE_LEN = 182, 7_900
HPV16_TYPE_INDEX = 15  # HPV16REF: the type the sublineages derive from
HPV16_SUBLINEAGES = ("A1", "A2", "A3", "A4", "B1", "B2", "C1", "D1", "D2", "D3")
CALL_GENOME_LEN = 7_906


def random_codes(rng, n: int) -> np.ndarray:
    """n uniform 2-bit base codes (0..3) as uint8."""
    return rng.integers(0, 4, size=n, dtype=np.uint8)


def substitute(codes: np.ndarray, rate: float, rng) -> np.ndarray:
    """Copy of a code array with each base replaced, at `rate`, by one of
    the three other bases."""
    out = codes.copy()
    hit = rng.random(codes.shape, dtype=np.float32) < rate
    shift = rng.integers(1, 4, size=int(hit.sum()), dtype=np.uint8)
    out[hit] = (out[hit] + shift) & np.uint8(3)
    return out


def to_bytes(codes: np.ndarray) -> bytes:
    return _ASCII[codes].tobytes()


def zika_panel(rng, n_refs: int = ZIKA_REFS, length: int = ZIKA_REF_LEN,
               clades: int = 4, clade_div: float = 0.05,
               strain_div: float = 0.01) -> list[SeqRecord]:
    """Strain panel: clades `clade_div` away from a root genome, strains
    `strain_div` away from their clade — close references, so the
    argmax and its diff filter have real ties to break."""
    root = random_codes(rng, length)
    clade_codes = [substitute(root, clade_div, rng) for _ in range(clades)]
    return [
        SeqRecord(f"strain{i:03d}_clade{i % clades}",
                  to_bytes(substitute(clade_codes[i % clades], strain_div, rng)))
        for i in range(n_refs)
    ]


def _codes_of(seq: bytes) -> np.ndarray:
    return np.searchsorted(_ASCII, np.frombuffer(seq, np.uint8)).astype(np.uint8)


def iter_reads(rng, sources: list[bytes], n: int, *, length: int = 0,
               mean_len: int = 0, sd_len: int = 0, min_len: int = 1,
               sub_rate: float = 0.0, n_run_frac: float = 0.0,
               n_run_max: int = 8, prefix: str = "read", chunk: int = 65_536):
    """Yield lists of SeqRecord (at most `chunk` each), n reads in all.

    Each read is a random window of a random source with substitutions at
    `sub_rate`; a fraction `n_run_frac` of reads also carries one run of
    1..n_run_max `N`s.  Fixed `length`, or lengths drawn from a normal of
    (mean_len, sd_len) clipped to [min_len, source length]."""
    src = [_codes_of(s) for s in sources]
    lens = np.array([len(s) for s in src])
    grid = np.zeros((len(src), lens.max()), np.uint8)
    for i, c in enumerate(src):
        grid[i, : len(c)] = c
    done = 0
    while done < n:
        m = min(chunk, n - done)
        which = rng.integers(0, len(src), size=m)
        if length:
            rl = np.minimum(length, lens[which])
        else:
            rl = np.clip(rng.normal(mean_len, sd_len, size=m).astype(np.int64),
                         min_len, lens[which])
        starts = (rng.random(m) * (lens[which] - rl + 1)).astype(np.int64)
        width = int(rl.max())
        idx = np.minimum(starts[:, None] + np.arange(width), lens.max() - 1)
        seqs = _ASCII[substitute(grid[which[:, None], idx], sub_rate, rng)]
        for i in np.nonzero(rng.random(m) < n_run_frac)[0]:
            run = int(rng.integers(1, n_run_max + 1))
            at = int(rng.integers(0, max(1, rl[i] - run)))
            seqs[i, at: at + run] = _N
        yield [
            SeqRecord(f"{prefix}{done + i}", seqs[i, : rl[i]].tobytes(),
                      b"I" * int(rl[i]))
            for i in range(m)
        ]
        done += m


def write_fasta(path, records) -> None:
    with open(path, "wb") as fh:
        for r in records:
            fh.write(b">" + r.name.encode() + b"\n" + r.seq + b"\n")


def write_fastq(path, chunks) -> list[SeqRecord]:
    """Write record chunks (an iter_reads generator, or one list) as
    FASTQ; returns the first chunk for oracle checks."""
    first = None
    if isinstance(chunks, list):
        chunks = [chunks]
    with open(path, "wb") as fh:
        for recs in chunks:
            if first is None:
                first = recs
            fh.write(b"".join(
                b"@" + r.name.encode() + b"\n" + r.seq + b"\n+\n"
                + (r.qual or b"I" * len(r.seq)) + b"\n"
                for r in recs))
    return first or []


def hpv_refpath(path, rng, n_types: int = HPV_TYPES,
                type_len: int = HPV_TYPE_LEN, lineage_div: float = 0.01,
                sublineage_div: float = 0.005):
    """Write a synthetic `hpv16 -R` directory: ``all_pave_ref.fa`` (the
    type panel, names HPV<n>REF) and ``new_refs.fa`` (HPV16 sublineage
    genomes keyed A1..D3, lineage = first letter, derived from type
    HPV16REF `lineage_div` + `sublineage_div` away).  Returns
    (type records, sublineage records)."""
    os.makedirs(path, exist_ok=True)
    tlens = rng.integers(type_len - 300, type_len + 301, size=n_types)
    types = [SeqRecord(f"HPV{i + 1}REF", to_bytes(random_codes(rng, int(n))))
             for i, n in enumerate(tlens)]
    base = _codes_of(types[min(HPV16_TYPE_INDEX, n_types - 1)].seq)
    lineages = {ln: substitute(base, lineage_div, rng)
                for ln in sorted({s[0] for s in HPV16_SUBLINEAGES})}
    subs = [SeqRecord(s, to_bytes(substitute(lineages[s[0]], sublineage_div, rng)))
            for s in HPV16_SUBLINEAGES]
    write_fasta(os.path.join(path, "all_pave_ref.fa"), types)
    write_fasta(os.path.join(path, "new_refs.fa"), subs)
    return types, subs


def plant_snps(seq: bytes, n: int, rng, margin: int = 50,
               spacing: int = 40) -> tuple[bytes, list[int]]:
    """Copy of `seq` with n SNPs at sorted 0-based positions at least
    `spacing` apart and `margin` from either end."""
    slots = np.arange(margin, len(seq) - margin, spacing)
    pos = np.sort(rng.choice(slots, size=n, replace=False))
    codes = _codes_of(seq)
    codes[pos] = (codes[pos] + rng.integers(1, 4, size=n, dtype=np.uint8)) & np.uint8(3)
    return to_bytes(codes), pos.tolist()
