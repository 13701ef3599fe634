"""Sketch construction and intersection counting vs the scalar oracle."""

import numpy as np
import pytest

from rkmh_tpu import oracle
from rkmh_tpu.io.packing import encode_seqs
from rkmh_tpu.ops.hashing import kmer_window_hashes
from rkmh_tpu.ops.sketch import SENTINEL, bottom_s_sketch
from rkmh_tpu.ops.intersect import (
    distinct_intersection_counts,
    intersection_counts,
    occ_ranks,
    sort_hashes_padded,
)


def random_dna(rng, n, with_n=False):
    alphabet = b"ACGT" + (b"N" if with_n else b"")
    return bytes(rng.choice(np.frombuffer(alphabet, dtype=np.uint8), size=n))


def test_bottom_s_matches_oracle():
    rng = np.random.default_rng(3)
    k, s = 12, 20
    seqs = [random_dna(rng, n, with_n=True) for n in (25, 40, 120, 12)]
    codes, lens = encode_seqs(seqs, pad_to=128, granularity=1)
    hashes = kmer_window_hashes(codes, k)
    sk, sk_lens = bottom_s_sketch(hashes, s)
    sk = np.asarray(sk)
    sk_lens = np.asarray(sk_lens)
    for i, q in enumerate(seqs):
        exp = oracle.minhashes(oracle.calc_hashes(q, k), s)
        assert sk_lens[i] == len(exp)
        assert [int(x) for x in sk[i, : len(exp)]] == exp
        assert np.all(sk[i, len(exp):] == SENTINEL)


def test_occ_ranks():
    rows = np.array([[1, 1, 2, 2, 2, 5, 7, 7]], dtype=np.uint64)
    occ = np.asarray(occ_ranks(rows))
    assert occ.tolist() == [[0, 1, 0, 1, 2, 0, 0, 1]]


def _np_sketch_rows(hash_lists, s):
    rows = np.full((len(hash_lists), s), int(SENTINEL), dtype=np.uint64)
    lens = np.zeros(len(hash_lists), dtype=np.int32)
    for i, h in enumerate(hash_lists):
        mh = oracle.minhashes(h, s)
        rows[i, : len(mh)] = mh
        lens[i] = len(mh)
    return rows, lens


def test_intersection_counts_with_duplicates():
    # hand-built multisets exercising min-multiplicity semantics
    a = [[3, 3, 5, 9], [1, 2, 3, 4]]
    b = [[3, 5, 5, 9], [3, 3, 3, 10], [11, 12, 13, 14]]
    s = 6
    A, al = _np_sketch_rows(a, s)
    B, bl = _np_sketch_rows(b, s)
    got = np.asarray(intersection_counts(A, al, B, bl))
    exp = np.array(
        [[oracle.intersection_size(sorted(x), sorted(y)) for y in b] for x in a]
    )
    assert np.array_equal(got, exp)


def test_intersection_counts_random_vs_oracle():
    rng = np.random.default_rng(11)
    k, s = 12, 30
    reads = [random_dna(rng, 60, with_n=True) for _ in range(9)]
    refs = [random_dna(rng, 300) for _ in range(5)]
    rc_codes, _ = encode_seqs(reads, pad_to=64, granularity=1)
    rf_codes, _ = encode_seqs(refs, pad_to=320, granularity=1)
    rsk, rlen = bottom_s_sketch(kmer_window_hashes(rc_codes, k), s)
    fsk, flen = bottom_s_sketch(kmer_window_hashes(rf_codes, k), s)
    got = np.asarray(intersection_counts(rsk, rlen, fsk, flen))
    for i, rd in enumerate(reads):
        a = oracle.minhashes(oracle.calc_hashes(rd, k), s)
        for j, rf in enumerate(refs):
            b = oracle.minhashes(oracle.calc_hashes(rf, k), s)
            assert got[i, j] == oracle.intersection_size(a, b), (i, j)


def test_distinct_intersection_counts():
    a = [[3, 3, 5, 9, 9, 9], [0, 1, 2, 3, 4, 5]]
    b = [[3, 9, 9, 20, 21, 22]]
    A = np.sort(np.array(a, dtype=np.uint64), axis=-1)
    al = np.array([6, 6], dtype=np.int32)
    B = np.sort(np.array(b, dtype=np.uint64), axis=-1)
    got = np.asarray(distinct_intersection_counts(A, al, B))
    assert got[0, 0] == 2  # {3, 9}
    assert got[1, 0] == 1  # {3}


def test_sort_hashes_padded_keeps_zeros():
    h = np.array([[5, 0, 3, 7]], dtype=np.uint64)
    mask = np.array([[True, True, True, False]])
    x, lens = sort_hashes_padded(h, mask)
    assert np.asarray(x)[0].tolist() == [0, 3, 5, int(SENTINEL)]
    assert int(lens[0]) == 3


@pytest.mark.parametrize("shape", [(1, 1), (16, 149), (16, 257), (3, 4591)])
def test_sort_u64_rows_matches_numpy(shape):
    """The one u64 row sort orders values exactly like numpy, high bits,
    duplicates, 0 and the all-ones sentinel included."""
    import numpy as np
    import jax.numpy as jnp
    from rkmh_tpu.ops.sketch import sort_u64_rows

    rng = np.random.default_rng(shape[1])
    x = rng.integers(0, 2**64, size=shape, dtype=np.uint64)
    if shape[1] >= 5:
        x[0, :5] = [0, 1, 2**32 - 1, 2**32, 2**63]
        x[-1] = x[-1][0]  # constant row
        x[0, -1] = SENTINEL
    got = np.asarray(sort_u64_rows(jnp.asarray(x)))
    assert np.array_equal(got, np.sort(x, axis=-1))
