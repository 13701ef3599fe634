"""Bit-exactness tests for the clean-room MurmurHash3_x64_128.

Authoritative anchor: the mmh3 package documents
``mmh3.hash64("foo") == (-2129773440516405919, 9128664383759220103)``
(mmh3 README), where hash64 is MurmurHash3_x64_128 seed 0 split into two
signed 64-bit ints.  Matching it proves this implementation is the
canonical Appleby algorithm, not merely self-consistent.  The SMHasher
chained-verification procedure result is additionally frozen as a
regression value covering every tail length 0..15 and the block path.
"""

import numpy as np
import pytest

from rkmh_tpu.ops.murmur3 import (
    murmur3_x64_128,
    murmur3_x64_128_digest_np,
    murmur3_x64_128_h1,
    murmur3_x64_128_np,
)


def test_mmh3_documented_vector():
    h1, h2 = murmur3_x64_128_np(b"foo", seed=0)
    assert np.int64(np.uint64(h1)) == -2129773440516405919
    assert np.int64(np.uint64(h2)) == 9128664383759220103
    # empty input, seed 0 -> all-zero digest (canonical property)
    assert murmur3_x64_128_digest_np(b"", 0) == b"\x00" * 16


def test_smhasher_procedure_frozen():
    """SMHasher verification procedure, frozen at first run (regression)."""
    hashes = bytearray()
    for i in range(256):
        key = bytes(range(i))
        digest = murmur3_x64_128_digest_np(key, seed=256 - i)
        hashes += digest
    final = murmur3_x64_128_digest_np(bytes(hashes), seed=0)
    verification = int.from_bytes(final[:4], "little")
    assert verification == 0x8AC6F54E, hex(verification)


@pytest.mark.parametrize("length", [1, 8, 9, 12, 15, 16, 17, 18, 31, 33, 100])
def test_jax_matches_numpy_golden(length):
    import jax

    seed = 42
    rng = np.random.default_rng(length * 1000 + seed)
    batch = rng.integers(0, 256, size=(17, length), dtype=np.uint8)
    h1, h2 = jax.jit(lambda b: murmur3_x64_128(b, seed=seed))(batch)
    h1 = np.asarray(h1)
    h2 = np.asarray(h2)
    for row in range(batch.shape[0]):
        e1, e2 = murmur3_x64_128_np(batch[row].tobytes(), seed=seed)
        assert int(h1[row]) == e1
        assert int(h2[row]) == e2


def test_dna_kmer_hashes_seed42():
    """Freeze a few DNA k-mer vectors (seed 42, as rkmh uses)."""
    for kmer in [b"ACGTACGTACGT", b"AAAAAAAAAAAAAAAA", b"GATTACAGATTACAGATT"]:
        arr = np.frombuffer(kmer, dtype=np.uint8)[None, :]
        got = int(np.asarray(murmur3_x64_128_h1(arr, seed=42))[0])
        exp, _ = murmur3_x64_128_np(kmer, seed=42)
        assert got == exp


def test_batched_shapes():
    rng = np.random.default_rng(0)
    batch = rng.integers(0, 256, size=(3, 5, 12), dtype=np.uint8)
    h1, _ = murmur3_x64_128(batch, seed=42)
    assert h1.shape == (3, 5)


# ---------------------------------------------------------------------------
# bulk oracle: numpy murmur + canonical window hashing vs the scalar oracle
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", [1, 7, 12, 16, 17, 18, 31, 32, 33, 40])
def test_calc_hashes_np_matches_scalar(k):
    from rkmh_tpu import oracle

    rng = np.random.default_rng(k)
    alphabet = np.frombuffer(b"ACGTNacgtnRY", np.uint8)
    p = np.array([20, 20, 20, 20, 2, 4, 4, 4, 4, 1, 0.5, 0.5])
    for _ in range(6):
        n = int(rng.integers(0, 150))
        seq = rng.choice(alphabet, size=n, p=p / p.sum()).tobytes()
        assert oracle.calc_hashes_np(seq, k).tolist() == oracle.calc_hashes(seq, k)


def test_calc_hashes_np_multi_k_and_rows():
    from rkmh_tpu import oracle

    seq = b"ACGTTGCAACGGTACCAGTTAGGACCATTGACN" * 3
    assert oracle.calc_hashes_np(seq, [12, 16]).tolist() == \
        oracle.calc_hashes(seq, [12, 16])
    rows = np.frombuffer(b"hello, murmur!!!" * 2, np.uint8).reshape(2, 16)
    want = [murmur3_x64_128_np(bytes(r), 42)[0] for r in rows]
    assert oracle.murmur3_h1_rows(rows, 42).tolist() == want


def test_multiset_panel_matches_scalar_intersections():
    from rkmh_tpu import oracle

    rng = np.random.default_rng(5)
    rows = [np.sort(rng.integers(1, 40, size=int(rng.integers(0, 30))))
            .astype(np.uint64) for _ in range(7)]
    panel = oracle.MultisetPanel(rows)
    for _ in range(10):
        q = np.sort(rng.integers(1, 40, size=25)).astype(np.uint64)
        got = panel.counts(q).tolist()
        want = [oracle.intersection_size(q.tolist(), r.tolist()) for r in rows]
        assert got == want
        got_d = panel.counts(q, distinct=True).tolist()
        want_d = [oracle.set_intersection_size(q.tolist(), r.tolist()) for r in rows]
        assert got_d == want_d
