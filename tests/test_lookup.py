"""Panel lookup table (ops/lookup.py) must be bit-identical to the
searchsorted reference kernel (ops/intersect.py) incl. duplicates."""

import numpy as np

from rkmh_tpu.io.packing import encode_seqs
from rkmh_tpu.ops.hashing import kmer_window_hashes
from rkmh_tpu.ops.sketch import SENTINEL, bottom_s_sketch
from rkmh_tpu.ops.intersect import intersection_counts
from rkmh_tpu.ops.lookup import build_panel_table, lookup_intersection_counts


def random_dna(rng, n, with_n=False):
    alphabet = b"ACGT" + (b"N" if with_n else b"")
    return bytes(rng.choice(np.frombuffer(alphabet, dtype=np.uint8), size=n))


def test_lookup_matches_searchsorted_random():
    rng = np.random.default_rng(5)
    k, s = 12, 64
    # repeat-rich refs to force duplicate hashes in sketches
    unit = random_dna(rng, 80)
    refs = [unit * 3 + random_dna(rng, 200) for _ in range(70)]  # >64 refs: 3 mask words
    reads = [random_dna(rng, 70, with_n=True) for _ in range(33)]
    rc, _ = encode_seqs(reads, pad_to=80, granularity=1)
    fc, _ = encode_seqs(refs, pad_to=512, granularity=1)
    rsk, rlen = bottom_s_sketch(kmer_window_hashes(rc, k), s)
    fsk, flen = bottom_s_sketch(kmer_window_hashes(fc, k), s)
    want = np.asarray(intersection_counts(rsk, rlen, fsk, flen))

    table = build_panel_table(np.asarray(fsk), np.asarray(flen))
    got = np.asarray(
        lookup_intersection_counts(rsk, rlen, table.device_arrays(), len(refs))
    )
    assert np.array_equal(got, want)


def test_lookup_duplicate_multiplicity():
    # hand-built multisets: value 3 x2 in read, x3 in ref -> min = 2
    read = np.array([[3, 3, 5, 9, int(SENTINEL), int(SENTINEL)]], dtype=np.uint64)
    rlen = np.array([4], dtype=np.int32)
    ref = np.array([[3, 3, 3, 5, 11, int(SENTINEL)]], dtype=np.uint64)
    flen = np.array([5], dtype=np.int32)
    table = build_panel_table(ref, flen)
    got = np.asarray(lookup_intersection_counts(read, rlen, table.device_arrays(), 1))
    assert got[0, 0] == 3  # min(2,3) for value 3 + 1 for value 5


def test_device_panel_table_matches_host():
    """build_panel_table_device == build_panel_table at the counts level,
    including duplicate (occ > 0) entries."""
    import jax.numpy as jnp

    from rkmh_tpu.ops.lookup import build_panel_table_device

    rng = np.random.default_rng(5)
    k, s = 12, 64
    unit = random_dna(rng, 80)
    refs = [unit * 3 + random_dna(rng, 200) for _ in range(70)]
    reads = [random_dna(rng, 70, with_n=True) for _ in range(33)]
    rc, _ = encode_seqs(reads, pad_to=80, granularity=1)
    fc, _ = encode_seqs(refs, pad_to=512, granularity=1)
    rsk, rlen = bottom_s_sketch(kmer_window_hashes(rc, k), s)
    fsk, flen = bottom_s_sketch(kmer_window_hashes(fc, k), s)

    host = build_panel_table(np.asarray(fsk), np.asarray(flen))
    dev = build_panel_table_device(fsk, jnp.asarray(flen))
    want = np.asarray(lookup_intersection_counts(rsk, rlen, host.device_arrays(), 70))
    got = np.asarray(lookup_intersection_counts(rsk, rlen, (dev,), 70))
    assert np.array_equal(got, want)


def test_nosort_short_read_path_matches_sorted():
    """The sort-free classify computation (prefix-equality occ ranks +
    order-free masked lookup — the accelerator W <= s path inside
    engine._table_counts_from_codes) must be bit-identical to the sorted
    bottom-s path, duplicates and invalid windows included — built
    explicitly, and through the jitted wrapper with accel=True."""
    import numpy as np
    import jax.numpy as jnp
    from rkmh_tpu.classify import engine
    from rkmh_tpu.ops.lookup import (
        build_panel_table,
        lookup_intersection_counts,
        lookup_intersection_counts_masked,
    )
    from rkmh_tpu.ops.sketch import bottom_s_sketch
    from rkmh_tpu.ops.hashing import multi_k_window_hashes
    from rkmh_tpu.utils import to_host

    rng = np.random.default_rng(42)
    # tiny alphabet slice so duplicate k-mers (and thus occ>0 ranks) occur
    read_codes = rng.integers(0, 3, size=(32, 64)).astype(np.uint8)
    read_codes[5, 10:20] = 255            # invalid stretch -> 0-hashes
    read_codes[11, :] = read_codes[3, :]  # exact duplicate read
    ref_codes = rng.integers(0, 3, size=(6, 256)).astype(np.uint8)

    ks, s = (8,), 1000  # W = 57 <= s
    ref_sk, ref_lens = engine.sketch_batch(ref_codes, ks, s)
    panel = build_panel_table(np.asarray(ref_sk), np.asarray(ref_lens))
    table = jnp.asarray(panel.table)

    hashes = multi_k_window_hashes(read_codes, list(ks))
    W = hashes.shape[-1]

    # sort-free computation exactly as _table_counts_from_codes builds it
    valid = hashes != np.uint64(0)
    lower = np.tril(np.ones((W, W), dtype=bool), k=-1)
    eq = hashes[:, None, :] == hashes[:, :, None]
    occ = jnp.sum(eq & lower[None], axis=-1).astype(jnp.uint32)
    ns_lens = jnp.sum(valid, axis=-1).astype(jnp.int32)
    ns_counts = lookup_intersection_counts_masked(
        hashes, valid, occ, (table,), panel.num_refs
    )

    sk, sk_lens = bottom_s_sketch(hashes, s)
    so_counts = lookup_intersection_counts(sk, sk_lens, (table,), panel.num_refs)

    a = to_host((ns_counts, ns_lens))
    b = to_host((so_counts, sk_lens))
    assert np.array_equal(np.asarray(a[0]), np.asarray(b[0]))
    assert np.array_equal(np.asarray(a[1]), np.asarray(b[1]))

    assert engine.use_nosort(W, s, accel=True)
    kw = dict(ks=ks, sketch_size=s, num_refs=panel.num_refs, min_diff=0,
              min_matches=3)
    nosort = engine.classify_codes_table_packed2(read_codes, table, accel=True, **kw)
    sort = engine.classify_codes_table_packed2(read_codes, table, accel=False, **kw)
    assert np.array_equal(np.asarray(nosort), np.asarray(sort))


def test_packed4_wire_format_classify_identical():
    """2-bit packed code upload (pack_codes4 -> device unpack) must give
    byte-identical classify results, invalid bases and padding included."""
    import numpy as np
    import jax.numpy as jnp
    from rkmh_tpu.classify import engine
    from rkmh_tpu.io.packing import pack_codes4
    from rkmh_tpu.ops.lookup import build_panel_table
    from rkmh_tpu.utils import to_host

    rng = np.random.default_rng(3)
    codes = rng.integers(0, 4, size=(24, 64)).astype(np.uint8)
    codes[3, 10:14] = 4        # invalid base byte value from the encoder
    codes[5, 40:] = 255        # padding
    ref_codes = rng.integers(0, 4, size=(5, 256)).astype(np.uint8)

    ks, s = (12,), 40  # W=53 > s -> exercises the sorted path through unpack
    ref_sk, ref_lens = engine.sketch_batch(ref_codes, ks, s)
    panel = build_panel_table(np.asarray(ref_sk), np.asarray(ref_lens))
    table = jnp.asarray(panel.table)

    want = to_host(engine.classify_codes_table_packed2(
        codes, table, ks=ks, sketch_size=s,
        num_refs=panel.num_refs, min_diff=0, min_matches=2,
    ))
    pk, vb = pack_codes4(codes)
    got = to_host(engine.classify_packed4_table_packed2(
        pk, vb, 64, table, ks=ks, sketch_size=s,
        num_refs=panel.num_refs, min_diff=0, min_matches=2,
    ))
    assert np.array_equal(np.asarray(got), np.asarray(want))

    # unpack round-trips exactly for encoder-produced byte values
    codes2 = np.where(codes < 4, codes, 255).astype(np.uint8)
    pk2, vb2 = pack_codes4(codes2)
    back = np.asarray(engine.unpack_codes4(pk2, vb2, 64))
    assert np.array_equal(back, codes2)

    # depth-filter and hash wrappers agree too
    lens = np.full(24, 64, np.int32)
    h1, m1 = engine.hash_batch_with_mask(codes, lens, ks)
    h2, m2 = engine.hash_packed4_with_mask(pk, vb, lens, 64, ks)
    assert np.array_equal(np.asarray(h1), np.asarray(h2))
    assert np.array_equal(np.asarray(m1), np.asarray(m2))


def test_packed4_sketch_and_hpv16_variants_identical():
    """sketch_packed4(_depth_filtered) and hpv16_packed4_batch must match
    their raw-codes counterparts element for element."""
    import numpy as np
    import jax.numpy as jnp
    from rkmh_tpu.classify import engine
    from rkmh_tpu.io.packing import pack_codes4
    from rkmh_tpu.ops.counter import HashCounter
    from rkmh_tpu.ops.lookup import build_set_table_device
    from rkmh_tpu.utils import to_host

    rng = np.random.default_rng(8)
    codes = rng.integers(0, 4, size=(12, 96)).astype(np.uint8)
    codes[2, 80:] = 255
    lens = np.where(np.arange(12) == 2, 80, 96).astype(np.int32)
    pk, vb = pack_codes4(codes)
    ks = (14,)

    a = to_host(engine.sketch_batch(codes, ks, 30))
    b = to_host(engine.sketch_packed4(pk, vb, 96, ks, 30))
    assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])

    hc = HashCounter(4096)
    h, m = engine.hash_batch_with_mask(codes, lens, ks)
    hc.add(h, m)
    a = to_host(engine.sketch_batch_depth_filtered(codes, lens, hc.table, ks, 30, 2))
    b = to_host(engine.sketch_packed4_depth_filtered(pk, vb, lens, hc.table, 96, ks, 30, 2))
    assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])

    ref_codes = rng.integers(0, 4, size=(3, 200)).astype(np.uint8)
    rh, rm = engine.hash_batch_with_mask(
        ref_codes, np.full(3, 200, np.int32), ks
    )
    tt = build_set_table_device(rh, rm, num_refs=3)
    ut = build_set_table_device(rh[:2], rm[:2], num_refs=2)
    a = to_host(engine.hpv16_batch(codes, tt, ut, ks, 3, 2,
                                   counter_table=hc.table, min_occ=1))
    b = to_host(engine.hpv16_packed4_batch(pk, vb, 96, tt, ut, ks, 3, 2,
                                           counter_table=hc.table, min_occ=1))
    assert np.array_equal(np.asarray(a), np.asarray(b))


def test_hpv16_split_dispatch_identical_to_fused():
    """hpv16_batch_split / hpv16_packed4_batch_split (the 4-dispatch
    production path: stage1 -> two bare gathers -> finish) must be
    bit-identical to the single-jit hpv16_batch, with and without the
    -M depth filter."""
    import numpy as np
    from rkmh_tpu.classify import engine
    from rkmh_tpu.io.packing import pack_codes4
    from rkmh_tpu.ops.counter import HashCounter
    from rkmh_tpu.ops.lookup import build_set_table_device
    from rkmh_tpu.utils import to_host

    rng = np.random.default_rng(21)
    codes = rng.integers(0, 4, size=(12, 96)).astype(np.uint8)
    codes[3, 72:] = 255
    ks = (14, 16)

    ref_codes = rng.integers(0, 4, size=(4, 220)).astype(np.uint8)
    rh, rm = engine.hash_batch_with_mask(
        ref_codes, np.full(4, 220, np.int32), ks
    )
    tt = build_set_table_device(rh, rm, num_refs=4)
    ut = build_set_table_device(rh[:3], rm[:3], num_refs=3)

    hc = HashCounter(4096)
    h, m = engine.hash_batch_with_mask(codes, np.full(12, 96, np.int32), ks)
    hc.add(h, m)

    pk, vb = pack_codes4(codes)
    for ctr, mo in [(None, 0), (hc.table, 1)]:
        want = to_host(engine.hpv16_batch(
            codes, tt, ut, ks, 4, 3, counter_table=ctr, min_occ=mo))
        got = to_host(engine.hpv16_batch_split(
            codes, tt, ut, ks, 4, 3, counter_table=ctr, min_occ=mo))
        assert np.array_equal(np.asarray(want), np.asarray(got))
        got_p = to_host(engine.hpv16_packed4_batch_split(
            pk, vb, 96, tt, ut, ks, 4, 3, counter_table=ctr, min_occ=mo))
        assert np.array_equal(np.asarray(want), np.asarray(got_p))


def test_hpv16_combined_table_identical_to_split():
    """The round-4 combined-table step (ONE table spanning type bits +
    uniq-group bits, probe compacted to the host width bound) must be
    bit-identical to hpv16_batch over separate tables — for every legal
    compact width, with and without -M, raw and packed wire formats."""
    import numpy as np
    import jax.numpy as jnp
    from rkmh_tpu.classify import engine
    from rkmh_tpu.io.packing import pack_codes4
    from rkmh_tpu.ops.counter import HashCounter
    from rkmh_tpu.ops.lookup import build_set_table_device
    from rkmh_tpu.utils import to_host

    rng = np.random.default_rng(33)
    codes = rng.integers(0, 4, size=(12, 96)).astype(np.uint8)
    codes[3, 72:] = 255                      # short read -> pad tail
    codes[5, :] = codes[4, :]                # duplicate read (occ>0 dups)
    lens = np.full(12, 96, np.int32)
    lens[3] = 72
    ks = (14, 16)

    ref_codes = rng.integers(0, 4, size=(7, 220)).astype(np.uint8)
    rh, rm = engine.hash_batch_with_mask(
        ref_codes, np.full(7, 220, np.int32), ks
    )
    tt = build_set_table_device(rh[:4], rm[:4], num_refs=4)
    ut = build_set_table_device(rh[4:], rm[4:], num_refs=3)
    ct = build_set_table_device(rh, rm, num_refs=7)  # combined: 4 types + 3

    hc = HashCounter(4096)
    h, m = engine.hash_batch_with_mask(codes, lens, ks)
    hc.add(h, m)

    W = sum(96 - k + 1 for k in ks)
    wc_host = engine.hpv16_compact_width(lens, 96, ks)
    assert wc_host >= int(jnp.max(engine.bottom_s_sketch(h, h.shape[-1])[1]))
    # the over-budget fallback: sorted-key panel over the SAME combined
    # refs (engine.hpv16_sorted_batch) must also be result-identical
    from rkmh_tpu.ops.lookup import build_sorted_panel

    rh_np, rm_np = to_host((rh, rm))
    keys, masks = build_sorted_panel(
        [rh_np[i][rm_np[i]] for i in range(7)], num_refs=7)
    keys, masks = jnp.asarray(keys), jnp.asarray(masks)

    pk, vb = pack_codes4(codes)
    for ctr, mo in [(None, 0), (hc.table, 1)]:
        want = np.asarray(to_host(engine.hpv16_batch(
            codes, tt, ut, ks, 4, 3, counter_table=ctr, min_occ=mo)))
        for Wc in (W, wc_host):
            got = to_host(engine.hpv16_batch_comb(
                codes, ct, ks, 4, 3, Wc, counter_table=ctr, min_occ=mo))
            assert np.array_equal(want, np.asarray(got)), (Wc, mo)
            got_p = to_host(engine.hpv16_packed4_batch_comb(
                pk, vb, 96, ct, ks, 4, 3, Wc,
                counter_table=ctr, min_occ=mo))
            assert np.array_equal(want, np.asarray(got_p)), (Wc, mo)
            got_s = to_host(engine.hpv16_sorted_batch(
                codes, keys, masks, ks, 4, 3, Wc,
                counter_table=ctr, min_occ=mo))
            assert np.array_equal(want, np.asarray(got_s)), (Wc, mo)
            got_sp = to_host(engine.hpv16_sorted_packed4_batch(
                pk, vb, 96, keys, masks, ks, 4, 3, Wc,
                counter_table=ctr, min_occ=mo))
            assert np.array_equal(want, np.asarray(got_sp)), (Wc, mo)


def test_hpv16_compact_width_bounds():
    """hpv16_compact_width: always >= every row's window count, <= W,
    and quantized to at most `grid` distinct values per padded length."""
    import numpy as np
    from rkmh_tpu.classify import engine

    ks = (16, 18)
    L = 4096
    W = sum(L - k + 1 for k in ks)
    seen = set()
    rng = np.random.default_rng(2)
    for _ in range(40):
        lens = rng.integers(0, L + 1, size=17).astype(np.int32)
        wc = engine.hpv16_compact_width(lens, L, ks)
        need = sum(int(np.max(np.maximum(lens - (k - 1), 0))) for k in ks)
        assert need <= wc <= W
        seen.add(wc)
    assert len(seen) <= 8
    # degenerate: all-pad batch still yields a positive static width
    assert engine.hpv16_compact_width(np.zeros(4, np.int32), L, ks) >= 1
    # full-length batch costs nothing: exactly W
    assert engine.hpv16_compact_width(np.full(4, L, np.int32), L, ks) == W


def test_pack4_native_matches_numpy():
    """The C packer (io/native rkmh_pack4) must reproduce the numpy
    layout byte for byte, including invalid-base zeroing and the
    little-endian validity bit order."""
    import numpy as np
    import pytest
    from rkmh_tpu.io.native import pack4_native
    from rkmh_tpu.io.packing import _pack_codes4_numpy

    rng = np.random.default_rng(5)
    codes = rng.integers(0, 6, size=(37, 168)).astype(np.uint8)  # 4,5 invalid
    codes[0, :] = 255
    codes[1, :] = 3
    native = pack4_native(codes)
    if native is None:
        pytest.skip("native IO library unavailable")
    pk_n, vb_n = native
    pk, vb = _pack_codes4_numpy(codes)
    assert np.array_equal(pk, pk_n)
    assert np.array_equal(vb, vb_n)
    # non-contiguous input goes through the ascontiguousarray path
    pk2, vb2 = pack4_native(codes[::2])
    pkr, vbr = _pack_codes4_numpy(codes[::2])
    assert np.array_equal(pk2, pkr) and np.array_equal(vb2, vbr)


def test_slot_width_auto_pick_and_cross_width_parity():
    """Tables built at any slot width must answer queries identically,
    and the auto-picker must respect forcing and the size budget."""
    import numpy as np
    import pytest
    from rkmh_tpu.ops import lookup
    from rkmh_tpu.classify import engine
    from rkmh_tpu.ops.lookup import (
        build_panel_table, pick_slots, table_slots,
        lookup_intersection_counts,
    )

    if lookup._FORCED_SLOTS:
        pytest.skip("RKMH_TPU_SLOTS forces a width; auto-pick asserts "
                    "don't apply")
    from rkmh_tpu.ops.sketch import bottom_s_sketch
    from rkmh_tpu.ops.hashing import multi_k_window_hashes
    from rkmh_tpu.utils import to_host

    assert pick_slots(100, 2, forced=8) == 8
    assert pick_slots(100, 2) == 2            # tiny panel -> smallest rows
    assert pick_slots(50_000_000, 6) == 8     # huge panel -> 8 regardless
    # derivation round-trips for every width
    for s in (2, 3, 4, 8):
        assert table_slots(s * (3 + 2), 60) == s

    rng = np.random.default_rng(3)
    ref_codes = rng.integers(0, 4, size=(5, 300)).astype(np.uint8)
    read_codes = rng.integers(0, 4, size=(16, 120)).astype(np.uint8)
    ks, s_sk = (11,), 64
    rh = multi_k_window_hashes(ref_codes, list(ks))
    ref_sk, ref_lens = to_host(bottom_s_sketch(rh, s_sk))
    sk, sk_lens = engine.sketch_batch(read_codes, ks, s_sk)

    outs = []
    for s in (2, 3, 4, 8):
        pt = build_panel_table(ref_sk, ref_lens, slots=s)
        assert table_slots(pt.table.shape[1], pt.num_refs) == s
        counts = to_host(lookup_intersection_counts(
            sk, sk_lens, pt.device_arrays(), pt.num_refs))
        outs.append(np.asarray(counts))
    for a, b in zip(outs, outs[1:]):
        assert np.array_equal(a, b)
