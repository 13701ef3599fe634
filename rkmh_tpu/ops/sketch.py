"""Bottom-s MinHash sketch construction on device.

mkmh `minhashes` semantics (call sites rkmh.cpp:822/863/917; open-coded at
rkmh.cpp:1274-1284): sort all window hashes ascending, skip the 0 sentinel
(invalid k-mers), keep up to sketch_size.  Here a whole batch sketches in
one XLA sort: invalid/pad hashes are remapped to a MAX sentinel so the
bottom-s non-zero values land in the first s columns of the row sort.

Sketches are returned sorted ascending with SENTINEL padding in the tail,
plus a per-row valid-length vector — the layout the intersection kernels
consume directly.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

SENTINEL = np.uint64(0xFFFFFFFFFFFFFFFF)


def sort_u64_rows(x):
    """Ascending row sort of a u64 tensor (the one sort path on every
    backend)."""
    return jnp.sort(x, axis=-1)


def bottom_s_sketch(hashes, sketch_size: int):
    """[.., W] uint64 window hashes -> ([.., s] sorted sketch, [..] int32 len).

    Zeros (invalid k-mers / padding) are excluded exactly as rkmh does.
    Rows with fewer than s valid hashes get SENTINEL padding; `len` is the
    count of real entries (rkmh's min_num / read_min_lens).
    """
    x = jnp.where(hashes == np.uint64(0), SENTINEL, hashes)
    x = sort_u64_rows(x)
    W = x.shape[-1]
    # rows hold at most min(s, W) real values; keep the array that wide —
    # downstream intersection cost is proportional to this width, so
    # sentinel-padding short reads up to s would only waste queries
    sk = x[..., : min(sketch_size, W)]
    lens = jnp.sum(sk != SENTINEL, axis=-1).astype(jnp.int32)
    return sk, lens


def mask_by_frequency(hashes, counts, min_occ: int):
    """Zero out hashes whose observed depth is below min_occ — the mkmh
    mask_by_frequency used by `stream -M` (rkmh.cpp:916) and `hpv16 -M`
    (rkmh.cpp:2663).  `counts` are the per-hash depths already gathered
    from a counter (same shape as `hashes`)."""
    keep = counts >= jnp.asarray(min_occ, counts.dtype)
    return jnp.where(keep, hashes, np.uint64(0))


def mask_by_frequency_range(hashes, counts, min_occ: int, max_occ: int):
    """Keep hashes with depth in [min_occ, max_occ] — the mkmh
    minhashes_frequency_filter pre-mask used by `stream -I`
    (rkmh.cpp:835-836, bounds (0, max_samples))."""
    c = counts
    keep = (c >= jnp.asarray(min_occ, c.dtype)) & (c <= jnp.asarray(max_occ, c.dtype))
    return jnp.where(keep, hashes, np.uint64(0))


def sketch_is_sorted_invariant(sk) -> bool:
    """Debug helper: every row ascending with sentinel tail."""
    import numpy as _np

    a = _np.asarray(sk)
    return bool(_np.all(a[..., :-1] <= a[..., 1:]))
