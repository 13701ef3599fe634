"""Variant-calling engine: positional depth + brute-force mutation
enumeration, fully vectorized on device.

The reference's `call` (rkmh.cpp:1455-1904) walks each reference genome
position-by-position with a sliding depth window, and at low-depth sites
enumerates every 1-bp SNP (k positions x 3 bases) and 1-bp deletion
(k positions of the flanking (k+1)-mer), hashing each mutated k-mer and
looking its depth up in an exact read-hash map.  That is a scalar loop of
~4k hash+lookup per site.  Here the whole genome enumerates at once:

* positional window hashes  [P]          (ops/hashing, order-preserving)
* depth[j] = map[hash[j]]                (ops/hashmap, 2-probe cuckoo)
* trailing-window average   [P]          (cumsum, trunc division —
  matches the int avg_d = (double)sum/size of rkmh.cpp:1626-1633/1793)
* SNP alts [P, k, 3] and DEL alts [P, k] built as dense code tensors and
  hashed as [N, k] one-window batches through the same canonical murmur
  kernel the classify path uses.

Float comparisons replicate C++ double semantics bit-for-bit (x64 is on):
site if depth < .5*avg (rkmh.cpp:1801); SNP call if alt_depth >= .1*avg
&& alt_depth > depth (1814); DEL call if alt_depth > .9*avg (1858).

Quirks faithfully kept: depth of an invalid (non-ACGT) window is
map[0] — the count of *all* invalid read k-mers (the reference's
read_hash_to_depth[0]); DELs only for j > 0; pos = j + alt_pos + 1 for
both SNPs and DELs (the reference's formula, off-by-one included).
SNP enumeration at a non-ACGT origin base is undefined behavior in the
reference (rotate_snps falls off the function end, rkmh.cpp:1640-1654);
we mask those calls out instead.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from rkmh_tpu.ops.hashing import kmer_window_hashes
from rkmh_tpu.ops.hashmap import hashmap_get

# rotate_snps order (rkmh.cpp:1634-1654), in 2-bit codes A=0 C=1 G=2 T=3:
# A->(C,T,G)  C->(T,G,A)  G->(A,C,T)  T->(C,G,A)
ROT = np.array([[1, 3, 2], [3, 2, 0], [0, 1, 3], [1, 2, 0]], dtype=np.uint8)


def _slice_stack(codes, start: int, width: int, P: int):
    """[L] codes -> [P, width] window tensor via shifted slices (no gather)."""
    return jnp.stack([codes[start + p : start + p + P] for p in range(width)], axis=-1)


@partial(jax.jit, static_argnames=("k", "window_len"))
def call_scan_ref(ref_codes, table, k: int, window_len: int):
    """One reference row -> everything the caller needs.

    ref_codes: [L] uint8 (2-bit codes, >=4 invalid/pad).  Returns dict of
    [P]- and [P, k, 3]/[P, k]-shaped arrays (P = L-k+1); entries at
    j >= true_len-k+1 are garbage the host masks off.
    """
    L = ref_codes.shape[0]
    P = L - k + 1

    wh = kmer_window_hashes(ref_codes[None], k)[0]          # [P] u64
    depth = hashmap_get(table, wh)                          # [P] i32

    # trailing-window average over [max(0, j-w+1), j], truncated like
    # int avg_d = (double)sum / (double)size
    cs = jnp.cumsum(depth.astype(jnp.int64))
    j = jnp.arange(P)
    lo_idx = j - window_len
    lo = jnp.where(lo_idx >= 0, cs[jnp.clip(lo_idx, 0, None)], 0)
    wsum = cs - lo
    wsize = jnp.minimum(j + 1, window_len)
    avg = (wsum.astype(jnp.float64) / wsize.astype(jnp.float64)).astype(jnp.int32)

    site = depth.astype(jnp.float64) < 0.5 * avg.astype(jnp.float64)  # rkmh.cpp:1801

    # ---- SNP enumeration: [P, k, 3] -----------------------------------
    win = _slice_stack(ref_codes, 0, k, P)                  # [P, k]
    rot = jnp.asarray(ROT)                                  # [4, 3]
    safe = jnp.minimum(win, 3)
    alts = rot[safe]                                        # [P, k, 3]
    # alt kmer tensor: win broadcast with position p substituted
    eye = jnp.eye(k, dtype=bool)                            # [k(pos), k(col)]
    alt_codes = jnp.where(
        eye[None, :, None, :],                              # [1, k, 1, k]
        alts[:, :, :, None],                                # [P, k, 3, 1]
        win[:, None, None, :],                              # [P, 1, 1, k]
    )                                                       # [P, k, 3, k]
    snp_hash = kmer_window_hashes(alt_codes.reshape(-1, k), k)[:, 0].reshape(P, k, 3)
    snp_depth = hashmap_get(table, snp_hash)                # [P, k, 3]

    avg_f = avg.astype(jnp.float64)
    snp_call = (
        site[:, None, None]
        & (snp_depth.astype(jnp.float64) >= 0.1 * avg_f[:, None, None])
        & (snp_depth > depth[:, None, None])
        & (win < 4)[:, :, None]                             # UB-guard: valid origin
    )
    max_rescue = jnp.max(
        jnp.where(site[:, None, None], snp_depth, 0), axis=(1, 2)
    )                                                       # [P] (rkmh.cpp:1812)

    # ---- DEL enumeration: [P, k] ---------------------------------------
    # d_alt = ref[j-1 .. j+k] (k+1 chars, j>0); drop position ap in 1..k
    padded = jnp.concatenate([jnp.full((1,), 4, dtype=ref_codes.dtype), ref_codes])
    dwin = _slice_stack(padded, 0, k + 1, P)                # [P, k+1], row j = ref[j-1..j+k]
    dels = []
    for ap in range(1, k + 1):
        dels.append(jnp.concatenate([dwin[:, :ap], dwin[:, ap + 1 :]], axis=-1))
    del_codes = jnp.stack(dels, axis=1)                     # [P, k, k]
    del_hash = kmer_window_hashes(del_codes.reshape(-1, k), k)[:, 0].reshape(P, k)
    del_depth = hashmap_get(table, del_hash)
    del_call = (
        site[:, None]
        & (del_depth.astype(jnp.float64) > 0.9 * avg_f[:, None])
        & (j > 0)[:, None]                                  # rkmh.cpp:1847 j>0 guard
    )

    # win/dwin are NOT returned: the host already holds the reference
    # codes and rebuilds windows with stride tricks
    return dict(
        depth=depth, avg=avg, site=site,
        snp_depth=snp_depth, snp_call=snp_call, max_rescue=max_rescue,
        del_depth=del_depth, del_call=del_call,
    )
