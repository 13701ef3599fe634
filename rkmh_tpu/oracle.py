"""Scalar Python oracle for mkmh/rkmh hash+sketch semantics.

This is the executable specification the device kernels are tested against.
It reimplements, in plain Python on top of the golden NumPy murmur3, the
behavior of the (non-vendored) mkmh library as reconstructed from its rkmh
call sites (SURVEY.md §2.3):

* ``calc_hash``      — canonical k-mer hash: uppercase ACGT only; the hash
  is MurmurHash3_x64_128 (seed 42, low 64 bits) of the lexicographic min of
  the k-mer and its reverse complement (Mash convention; rkmh.cpp:494-497
  documents canonical=true / seed 42 / 64 bits).  Any non-ACGT character
  makes the k-mer invalid → hash 0 (the sentinel every rkmh sketch loop
  skips, e.g. rkmh.cpp:1233-1235, 1274-1276).
* ``calc_hashes``    — all k-mer hashes of a sequence in sequence order,
  concatenated across k sizes for multi-k (rkmh.cpp:303, 860).
* ``minhashes``      — bottom-s sketch: sort ascending, drop zeros, take
  up to s (rkmh.cpp:863 semantics; open-coded at rkmh.cpp:1274-1284).
* ``intersection_size`` — sorted-array intersection size with
  min-multiplicity duplicate semantics (std::set_intersection behavior),
  the hot comparator of rkmh.cpp:867-870.
"""

from __future__ import annotations

import numpy as np

from rkmh_tpu.ops.murmur3 import murmur3_x64_128_np

_COMP = {65: 84, 67: 71, 71: 67, 84: 65}  # A<->T, C<->G (ASCII)
_ACGT = frozenset(b"ACGT")


def revcomp(seq: bytes) -> bytes:
    return bytes(_COMP[b] for b in reversed(seq))


def calc_hash(kmer: bytes | str, seed: int = 42) -> int:
    """Canonical hash of one k-mer; 0 if it contains a non-ACGT base."""
    if isinstance(kmer, str):
        kmer = kmer.encode()
    kmer = kmer.upper()
    if any(b not in _ACGT for b in kmer):
        return 0
    rc = revcomp(kmer)
    canon = kmer if kmer <= rc else rc
    h1, _ = murmur3_x64_128_np(canon, seed)
    return h1


def calc_hashes(seq: bytes | str, ks: list[int] | int, seed: int = 42) -> list[int]:
    """All k-mer hashes in sequence order, concatenated over k sizes."""
    if isinstance(seq, str):
        seq = seq.encode()
    seq = seq.upper()
    if isinstance(ks, int):
        ks = [ks]
    out: list[int] = []
    for k in ks:
        for i in range(len(seq) - k + 1):
            out.append(calc_hash(seq[i : i + k], seed))
    return out


def minhashes(hashes: list[int], sketch_size: int) -> list[int]:
    """Bottom-s sketch: ascending sort, zeros excluded, up to s values."""
    nz = sorted(h for h in hashes if h != 0)
    return nz[:sketch_size]


def intersection_size(a: list[int], b: list[int]) -> int:
    """|multiset ∩| of two sorted hash arrays (min multiplicity per value)."""
    i = j = n = 0
    while i < len(a) and j < len(b):
        if a[i] < b[j]:
            i += 1
        elif a[i] > b[j]:
            j += 1
        else:
            n += 1
            i += 1
            j += 1
    return n


def hash_intersection(a: list[int], b: list[int]) -> list[int]:
    """Matching hashes of two sorted arrays, multiset semantics — the
    value-returning mkmh hash_intersection (equiv.hpp:268/282 call sites)."""
    i = j = 0
    out: list[int] = []
    while i < len(a) and j < len(b):
        if a[i] < b[j]:
            i += 1
        elif a[i] > b[j]:
            j += 1
        else:
            out.append(a[i])
            i += 1
            j += 1
    return out


def kmer_intersection(a: list, b: list) -> list:
    """Shared k-mer strings (legacy string-kmer comparator,
    equiv.hpp:435/237 kmer_intersection / kmer_heap_intersection)."""
    return hash_intersection(sorted(a), sorted(b))


def set_intersection_size(a: list[int], b: list[int]) -> int:
    """Distinct shared hash values (hpv16 type-level comparator)."""
    return len(set(a) & set(b))


# ---------------------------------------------------------------------------
# `call` oracle — scalar replication of rkmh.cpp:1766-1888
# ---------------------------------------------------------------------------

_ROTATE = {  # rotate_snps order, rkmh.cpp:1634-1654
    "A": "CTG", "C": "TGA", "T": "CGA", "G": "ACT",
}


def call_variants(ref_name: str, ref_seq: bytes, read_depth: dict[int, int],
                  k: int, window_len: int = 100):
    """Replicates the reference's per-ref call loop exactly.

    read_depth: hash -> count over every read k-mer occurrence (zeros
    included).  Returns (calls, depth_rows) where calls maps the VCF key
    string "ref\\tpos\\t.\\tREF\\tALT" -> [count, max_depth, avg_depth,
    orig_depth] and depth_rows is the per-position (avg, depth,
    max_rescue) list of the -d path.

    Documented deviation: the depth window resets per reference.  The
    reference's d_window is per-OpenMP-thread (rkmh.cpp:1769-1790) and
    carries history across whatever refs a thread happens to process —
    a thread-scheduling-dependent behavior with no deterministic analog
    (see PARITY.md; rkmh itself warns multi-ref VCFs are not correct).
    """
    seq = ref_seq.decode() if isinstance(ref_seq, bytes) else ref_seq
    seq = seq.upper()  # rkmh to_upper's before the call loop (rkmh.cpp:1610)
    P = len(seq) - k + 1
    hashes = [calc_hash(seq[j : j + k]) for j in range(P)]

    calls: dict[str, list[int]] = {}
    rows = []
    window: list[int] = []

    def record(key, alt_depth, avg_d, depth):
        ent = calls.setdefault(key, [0, 0, 0, 0])
        ent[0] += 1
        ent[2] = max(ent[2], avg_d)
        ent[3] = max(ent[3], depth)
        if alt_depth > ent[1]:
            ent[1] = alt_depth

    for j in range(P):
        depth = read_depth.get(hashes[j], 0)
        window.append(depth)
        if len(window) > window_len:
            window.pop(0)
        avg_d = int(sum(window) / len(window))  # (double) division, int trunc
        max_rescue = 0

        if depth < 0.5 * avg_d:
            kmer = seq[j : j + k]
            # SNPs (rkmh.cpp:1807-1838)
            for ap in range(k):
                orig = kmer[ap]
                for x in _ROTATE.get(orig, ""):
                    alt = kmer[:ap] + x + kmer[ap + 1 :]
                    alt_depth = read_depth.get(calc_hash(alt), 0)
                    max_rescue = max(max_rescue, alt_depth)
                    if alt_depth >= 0.1 * avg_d and alt_depth > depth:
                        pos = j + ap + 1
                        record(f"{ref_name}\t{pos}\t.\t{orig}\t{x}",
                               alt_depth, avg_d, depth)
            # 1bp deletions (rkmh.cpp:1845-1865)
            if j > 0:
                d_alt = seq[j - 1 : j + k]  # k+1 chars
                for ap in range(1, k + 1):
                    mod = d_alt[:ap] + d_alt[ap + 1 :]
                    alt_depth = read_depth.get(calc_hash(mod), 0)
                    if alt_depth > 0.9 * avg_d:
                        pos = j + ap + 1
                        record(f"{ref_name}\t{pos}\t.\t{d_alt[ap]}\t-",
                               alt_depth, avg_d, depth)

        rows.append((avg_d, depth, max_rescue))
    return calls, rows


def read_depth_map(reads: list[bytes], k: int) -> dict[int, int]:
    """hash -> occurrence count over all reads (zeros included,
    rkmh.cpp:1616-1623)."""
    if not reads:
        return {}
    h = np.concatenate([calc_hashes_np(seq, k) for seq in reads])
    u, c = np.unique(h, return_counts=True)
    return dict(zip(u.tolist(), c.tolist()))


def call_vcf_body(ref_name: str, ref_seq: bytes, reads: list[bytes], k: int,
                  window_len: int = 100) -> list[str]:
    """The VCF record lines `call` must emit for one reference: the
    call_variants aggregates in key order, in the reference's
    KC/MD/RD/OD INFO layout."""
    calls, _ = call_variants(ref_name, ref_seq, read_depth_map(reads, k), k,
                             window_len)
    return [f"{key}\t99\tPASS\tKC={v[0]};MD={v[1]};RD={v[2]};OD={v[3]}"
            for key, v in sorted(calls.items())]


# ---------------------------------------------------------------------------
# Bulk oracle: the same semantics over numpy arrays, for inputs at the read
# counts of a sequencing run.  calc_hashes_np is tested against calc_hash
# (tests/test_murmur3.py); everything above the hash is plain set/multiset
# arithmetic, independent of the device code.
# ---------------------------------------------------------------------------

_CODE = np.full(256, 4, np.uint8)
_CODE[list(b"ACGT")] = np.arange(4, dtype=np.uint8)
_ASCII = np.frombuffer(b"ACGT", np.uint8)
_U64 = np.uint64
_M64 = {"c1": _U64(0x87C37B91114253D5), "c2": _U64(0x4CF5AD432745937F),
        "f1": _U64(0xFF51AFD7ED558CCD), "f2": _U64(0xC4CEB9FE1A85EC53)}


def _rotl(x, r: int):
    return (x << _U64(r)) | (x >> _U64(64 - r))


def _fmix(x):
    x = x ^ (x >> _U64(33))
    x = x * _M64["f1"]
    x = x ^ (x >> _U64(33))
    x = x * _M64["f2"]
    return x ^ (x >> _U64(33))


def murmur3_h1_rows(data: np.ndarray, seed: int = 42) -> np.ndarray:
    """h1 of MurmurHash3_x64_128 for every row of an [N, n] uint8 array."""
    N, n = data.shape
    nw = max(2, -(-n // 16) * 2)
    buf = np.zeros((N, nw * 8), np.uint8)
    buf[:, :n] = data
    words = buf.view("<u8")
    c1, c2 = _M64["c1"], _M64["c2"]
    h1 = np.full(N, seed, _U64)
    h2 = np.full(N, seed, _U64)
    nblocks = n // 16
    for i in range(nblocks):
        h1 ^= _rotl(words[:, 2 * i] * c1, 31) * c2
        h1 = (_rotl(h1, 27) + h2) * _U64(5) + _U64(0x52DCEFB5)
        h2 ^= _rotl(words[:, 2 * i + 1] * c2, 33) * c1
        h2 = (_rotl(h2, 31) + h1) * _U64(5) + _U64(0x38495AB5)
    tail = n - 16 * nblocks
    if tail > 8:
        h2 ^= _rotl(words[:, 2 * nblocks + 1] * c2, 33) * c1
    if tail > 0:
        h1 ^= _rotl(words[:, 2 * nblocks] * c1, 31) * c2
    h1 ^= _U64(n)
    h2 ^= _U64(n)
    h1 = h1 + h2
    h2 = h2 + h1
    h1, h2 = _fmix(h1), _fmix(h2)
    return h1 + h2


def calc_hashes_np(seq: bytes | str, ks, seed: int = 42) -> np.ndarray:
    """calc_hashes as a uint64 array (same order, zeros for invalid)."""
    if isinstance(seq, str):
        seq = seq.encode()
    codes = _CODE[np.frombuffer(seq.upper(), np.uint8)].astype(np.int16)
    out = []
    for k in [ks] if isinstance(ks, int) else ks:
        if len(codes) < k:
            continue
        fwd = np.lib.stride_tricks.sliding_window_view(codes, k)
        rc = 3 - fwd[:, ::-1]
        diff = fwd != rc
        first = diff.argmax(axis=1)
        rows = np.arange(len(fwd))
        use_fwd = ~diff.any(axis=1) | (fwd[rows, first] < rc[rows, first])
        canon = np.where(use_fwd[:, None], fwd, rc)
        valid = (fwd < 4).all(axis=1)
        h = murmur3_h1_rows(_ASCII[np.where(valid[:, None], canon, 0)], seed)
        out.append(np.where(valid, h, _U64(0)))
    return np.concatenate(out) if out else np.zeros(0, _U64)


def minhashes_np(hashes: np.ndarray, sketch_size: int) -> np.ndarray:
    """minhashes over an array: ascending, zeros excluded, up to s."""
    return np.sort(hashes[hashes != 0])[:sketch_size]


class MultisetPanel:
    """Per-reference hash multisets, queried for intersection counts with
    intersection_size semantics (min multiplicity), or with
    set_intersection_size semantics when distinct=True."""

    def __init__(self, rows):
        vals, refs, cnts = [], [], []
        for r, row in enumerate(rows):
            u, c = np.unique(np.asarray(row, _U64), return_counts=True)
            vals.append(u)
            cnts.append(c)
            refs.append(np.full(len(u), r))
        self.R = len(vals)
        v = np.concatenate(vals) if vals else np.zeros(0, _U64)
        order = np.argsort(v, kind="stable")
        self.v = v[order]
        self.r = np.concatenate(refs)[order] if refs else np.zeros(0, int)
        self.c = np.concatenate(cnts)[order] if cnts else np.zeros(0, int)

    def counts(self, query, distinct: bool = False) -> np.ndarray:
        u, c = np.unique(np.asarray(query, _U64), return_counts=True)
        lo = np.searchsorted(self.v, u, "left")
        n = np.searchsorted(self.v, u, "right") - lo
        rep = np.repeat(np.arange(len(u)), n)
        pos = np.repeat(lo, n) + np.arange(n.sum()) - np.repeat(np.cumsum(n) - n, n)
        mult = 1 if distinct else np.minimum(c[rep], self.c[pos])
        w = np.broadcast_to(mult, pos.shape).astype(np.int64)
        return np.bincount(self.r[pos], weights=w, minlength=self.R).astype(np.int64)


def _slot_counts(hash_arrays, size: int):
    """A HASHTCounter of `size` slots over every hash (zeros included):
    returns lookup(h) -> counts at h's slot."""
    slots = np.concatenate([h % _U64(size) for h in hash_arrays]) if hash_arrays \
        else np.zeros(0, _U64)
    u, c = np.unique(slots, return_counts=True)

    def lookup(h):
        sl = h % _U64(size)
        i = np.clip(np.searchsorted(u, sl), 0, max(len(u) - 1, 0))
        return np.where((len(u) > 0) & (u[i] == sl), c[i], 0)

    return lookup


def stream_lines(refs, reads, ks, s: int, min_diff: int = 0,
                 min_matches: int = -1, min_kmer_occ: int | None = None,
                 max_samples: int | None = None,
                 counter_size: int = 200_000_000) -> list[str]:
    """`stream` output lines (rkmh.cpp:845-898): bottom-s sketches,
    multiset intersections, scan-argmax from -1 with strict >, FAIL tags.
    -I keeps ref hashes whose count over every ref occurrence is <=
    max_samples (rkmh.cpp:828-837); -M keeps read hashes whose count over
    every read occurrence is >= min_kmer_occ (rkmh.cpp:903-917); both
    counters are lossy modulo tables of counter_size slots."""
    ks = [ks] if isinstance(ks, int) else list(ks)
    ref_h = [calc_hashes_np(r.seq, ks) for r in refs]
    if max_samples is not None:
        cnt = _slot_counts(ref_h, counter_size)
        ref_h = [np.where(cnt(h) <= max_samples, h, _U64(0)) for h in ref_h]
    panel = MultisetPanel([minhashes_np(h, s) for h in ref_h])
    read_h = [calc_hashes_np(r.seq, ks) for r in reads]
    if min_kmer_occ is not None:
        cnt = _slot_counts(read_h, counter_size)
        read_h = [np.where(cnt(h) >= min_kmer_occ, h, _U64(0)) for h in read_h]
    lines = []
    for rec, h in zip(reads, read_h):
        mins = minhashes_np(h, s)
        max_shared, max_id, diff = -1, 0, 0
        for j, c in enumerate(panel.counts(mins).tolist()):
            if c > max_shared:
                diff = c - max_shared
                max_shared, max_id = c, j
        lines.append(
            f"{refs[max_id].name}\t{rec.name}\t{max_shared}\t{s}"
            f"{'FAIL:DEPTH' if len(mins) <= min_matches else ''}\t"
            f"{'FAIL:MATCHES' if max_shared < min_matches else ''}\t"
            f"{'' if diff > min_diff else 'FAIL:DIFF'}\n")
    return lines


def filter_records(refs, reads, ks, s: int, min_diff: int = 0,
                   min_matches: int = -1, min_kmer_occ: int | None = None,
                   max_samples: int | None = None,
                   counter_size: int = 10_000_000) -> str:
    """`filter` output (rkmh.cpp:996-1424, equiv.hpp:324-353): the records
    whose sketch passes depth, match and diff filters, argmax from 0.
    -I counts each ref hash once per sample (rkmh.cpp:340-357)."""
    ks = [ks] if isinstance(ks, int) else list(ks)
    ref_h = [calc_hashes_np(r.seq, ks) for r in refs]
    if max_samples is not None:
        cnt = _slot_counts([np.unique(h) for h in ref_h], counter_size)
        ref_h = [np.where(cnt(h) <= max_samples, h, _U64(0)) for h in ref_h]
    panel = MultisetPanel([minhashes_np(h, s) for h in ref_h])
    read_h = [calc_hashes_np(r.seq, ks) for r in reads]
    if min_kmer_occ is not None:
        cnt = _slot_counts(read_h, counter_size)
        read_h = [np.where(cnt(h) >= min_kmer_occ, h, _U64(0)) for h in read_h]
    out = []
    for rec, h in zip(reads, read_h):
        sk = minhashes_np(h, s)
        max_shared, prev_best = 0, 0
        for shared in panel.counts(sk).tolist():
            if shared > max_shared:
                prev_best, max_shared = max_shared, shared
        if len(sk) > 0 and max_shared >= min_matches \
                and (max_shared - prev_best) > min_diff:
            qual = rec.qual if rec.qual is not None else b"I" * len(rec.seq)
            out.append(f">{rec.name}\n{rec.seq.decode()}\n+\n{qual.decode()}\n")
    return "".join(out)


def hpv16_lines(types, subs, reads, k: int, min_kmer_occ: int = 0,
                counter_size: int = 800_000_000) -> list[str]:
    """`hpv16` output lines (rkmh.cpp:2656-2718): the type with the most
    distinct shared hashes (first wins ties), then lineage/sublineage
    unique-kmer similarities |read ∩ unique| / windows, sorted descending
    with ties in name order, formatted to 6 significant digits.  types
    and subs are records in file order; sublineage keys are their names
    (lineage = first letter).  -M zeroes read hashes whose count over
    every read occurrence is below min_kmer_occ (rkmh.cpp:2663)."""
    type_sets = [np.unique(calc_hashes_np(t.seq, k)) for t in types]
    types_panel = MultisetPanel([t[t != 0] for t in type_sets])
    sub_sets = {r.name: np.unique(calc_hashes_np(r.seq, k)) for r in subs}
    sub_names = sorted(sub_sets)
    lin_names = sorted({n[0] for n in sub_names})
    lin_sets = {ln: np.unique(np.concatenate(
        [sub_sets[n] for n in sub_names if n[0] == ln])) for ln in lin_names}

    def uniq(sets, name):
        others = [v for o, v in sets.items() if o != name]
        rest = np.unique(np.concatenate(others)) if others else np.zeros(0, _U64)
        u = np.setdiff1d(sets[name], rest)
        return u[u != 0]

    uniq_panel = MultisetPanel([uniq(lin_sets, ln) for ln in lin_names]
                               + [uniq(sub_sets, sn) for sn in sub_names])
    n_lin = len(lin_names)
    read_h = [calc_hashes_np(r.seq, k) for r in reads]
    if min_kmer_occ > 0:
        cnt = _slot_counts(read_h, counter_size)
        masked = [np.where(cnt(h) >= min_kmer_occ, h, _U64(0)) for h in read_h]
    else:
        masked = read_h
    lines = []
    for rec, h, hm in zip(reads, read_h, masked):
        hn = len(h)
        hset = np.unique(hm[hm != 0])
        counts = types_panel.counts(hset, distinct=True).tolist()
        best, mx = 0, -1
        for j, c in enumerate(counts):
            if c > mx:
                mx, best = c, j
        uc = uniq_panel.counts(hset, distinct=True).tolist()
        lin_ints, sub_ints = uc[:n_lin], uc[n_lin:]
        # zero-window reads get sim 0 (the reference would divide 0/0;
        # PARITY.md "deliberate improvements")
        lin_sims = [c / hn if hn else 0.0 for c in lin_ints]
        sub_sims = [c / hn if hn else 0.0 for c in sub_ints]
        lo = sorted(range(n_lin), key=lambda x: -lin_sims[x])
        so = sorted(range(len(sub_names)), key=lambda x: -sub_sims[x])
        lines.append(
            f"{rec.name}\t{types[best].name}\t{mx}/{hn}\t"
            + "".join(f"{lin_names[x]}:{lin_sims[x]:.6g};" for x in lo) + "\t"
            + "".join(f"{sub_names[x]}:{sub_sims[x]:.6g};" for x in so) + "\t"
            + "".join(f"{lin_ints[x]};" for x in lo) + "\t"
            + "".join(f"{sub_ints[x]};" for x in so))
    return lines
