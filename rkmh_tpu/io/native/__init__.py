"""ctypes loader for the native FASTA/FASTQ parser+packer.

Builds librkmh_io.so on first use (g++ -O3, cached next to the source);
falls back silently when no compiler is available — every caller must
treat `load()` returning None as "use the Python path".
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import numpy as np

_HERE = os.path.dirname(__file__)
_SRC = os.path.join(_HERE, "fastx_native.cpp")
_SO = os.path.join(_HERE, "librkmh_io.so")

_lib = None
_tried = False


class _RkmhBatch(ctypes.Structure):
    _fields_ = [
        ("n", ctypes.c_int64),
        ("pad_len", ctypes.c_int64),
        ("codes", ctypes.POINTER(ctypes.c_uint8)),
        ("lens", ctypes.POINTER(ctypes.c_int32)),
        ("names", ctypes.c_char_p),
        ("name_offs", ctypes.POINTER(ctypes.c_int64)),
        ("seqs", ctypes.c_char_p),
        ("seq_offs", ctypes.POINTER(ctypes.c_int64)),
        ("quals", ctypes.c_char_p),
        ("qual_offs", ctypes.POINTER(ctypes.c_int64)),
        ("rec_offs", ctypes.POINTER(ctypes.c_int64)),
    ]


def _build() -> bool:
    # build to a per-process temp name and rename into place: processes
    # that start together (test workers, --dist-procs ranks) must never
    # load a half-written library
    tmp = f"{_SO}.{os.getpid()}.tmp"
    cmd = [
        "g++", "-O3", "-march=native", "-shared", "-fPIC",
        _SRC, "-o", tmp, "-lz",
    ]
    try:
        subprocess.run(cmd, check=True, capture_output=True)
        os.replace(tmp, _SO)
        return True
    except (subprocess.CalledProcessError, FileNotFoundError, OSError) as e:
        print(f"rkmh_tpu: native io build skipped ({e})", file=sys.stderr)
        try:
            os.unlink(tmp)
        except OSError:
            pass
        return False


def load():
    """Return the loaded library, building it if needed; None on failure."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if not os.path.exists(_SO) or os.path.getmtime(_SO) < os.path.getmtime(_SRC):
        if not _build():
            return None
    try:
        lib = ctypes.CDLL(_SO)
    except OSError:
        return None
    lib.rkmh_read_fastx.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.POINTER(_RkmhBatch)
    ]
    lib.rkmh_read_fastx.restype = ctypes.c_int
    lib.rkmh_free.argtypes = [ctypes.POINTER(_RkmhBatch)]
    lib.rkmh_free.restype = None
    lib.rkmh_stream_open.argtypes = [ctypes.c_char_p]
    lib.rkmh_stream_open.restype = ctypes.c_void_p
    lib.rkmh_stream_next.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.POINTER(_RkmhBatch)
    ]
    lib.rkmh_stream_next.restype = ctypes.c_int64
    lib.rkmh_stream_close.argtypes = [ctypes.c_void_p]
    lib.rkmh_stream_close.restype = None
    lib.rkmh_stream_seek.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.rkmh_stream_seek.restype = ctypes.c_int
    _i64p = ctypes.POINTER(ctypes.c_int64)
    lib.rkmh_format_lines.argtypes = [
        _i64p, _i64p, _i64p, ctypes.c_int64, _i64p,
        ctypes.c_char_p, _i64p,
        ctypes.c_char_p, _i64p, ctypes.c_int64,
        ctypes.c_char_p, _i64p,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_char)),
    ]
    lib.rkmh_format_lines.restype = ctypes.c_int64
    lib.rkmh_buf_free.argtypes = [ctypes.POINTER(ctypes.c_char)]
    lib.rkmh_buf_free.restype = None
    _u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.rkmh_pack4.argtypes = [
        _u8p, ctypes.c_int64, ctypes.c_int64, _u8p, _u8p
    ]
    lib.rkmh_pack4.restype = None
    _u64p = ctypes.POINTER(ctypes.c_uint64)
    lib.rkmh_format_hash_lines.argtypes = [
        _u64p, _u8p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_char_p, _i64p,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_char)),
    ]
    lib.rkmh_format_hash_lines.restype = ctypes.c_int64
    _lib = lib
    return _lib


def format_hash_lines_block(vals: np.ndarray, mask: np.ndarray,
                            names: list) -> bytes | None:
    """Format a hash-dump batch ("name\\tv v v...\\n" per row) natively;
    None when the library is unavailable (callers fall back to the
    python join).  vals [n, W] uint64, mask [n, W] bool, one name per
    row."""
    lib = load()
    if lib is None:
        return None
    vals = np.ascontiguousarray(vals, dtype=np.uint64)
    mask = np.ascontiguousarray(mask, dtype=np.uint8)
    n, W = vals.shape
    blobs = [s.encode() if isinstance(s, str) else bytes(s) for s in names]
    name_offs = np.zeros(n + 1, np.int64)
    np.cumsum([len(b) for b in blobs], out=name_offs[1:])
    names_blob = b"".join(blobs)
    out = ctypes.POINTER(ctypes.c_char)()
    ln = lib.rkmh_format_hash_lines(
        vals.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        mask.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        n, W, names_blob, _i64_ptr(name_offs), ctypes.byref(out))
    if ln < 0:
        return None
    try:
        return ctypes.string_at(out, ln)
    finally:
        lib.rkmh_buf_free(out)


def pack4_native(codes: np.ndarray):
    """Native 2-bit packing (io/packing.pack_codes4 layout); None when
    the library is unavailable or the input is not C-contiguous u8."""
    lib = load()
    if lib is None:
        return None
    if codes.dtype != np.uint8 or not codes.flags.c_contiguous:
        codes = np.ascontiguousarray(codes, dtype=np.uint8)
    B, L = codes.shape
    packed = np.empty((B, L // 4), np.uint8)
    vbits = np.empty((B, L // 8), np.uint8)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.rkmh_pack4(codes.ctypes.data_as(u8p), B, L,
                   packed.ctypes.data_as(u8p), vbits.ctypes.data_as(u8p))
    return packed, vbits


def _i64_ptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def format_lines_block(arr, row_ids, names_blob: bytes, name_offs,
                       ref_blob: bytes, ref_offs,
                       tails_blob: bytes, tail_offs) -> bytes | None:
    """Format a [3, n] packed classify result into one output-byte block
    natively (see rkmh_format_lines).  None if the library is unavailable.

    row_ids maps result rows to records in names_blob/name_offs; None
    means identity.
    """
    lib = load()
    if lib is None:
        return None
    best = np.ascontiguousarray(arr[0], dtype=np.int64)
    shared = np.ascontiguousarray(arr[1], dtype=np.int64)
    flags = np.ascontiguousarray(arr[2], dtype=np.int64)
    n = best.shape[0]
    name_offs = np.ascontiguousarray(name_offs, dtype=np.int64)
    ref_offs = np.ascontiguousarray(ref_offs, dtype=np.int64)
    tail_offs = np.ascontiguousarray(tail_offs, dtype=np.int64)
    if row_ids is not None:
        row_ids = np.ascontiguousarray(row_ids, dtype=np.int64)
    out = ctypes.POINTER(ctypes.c_char)()
    ln = lib.rkmh_format_lines(
        _i64_ptr(best), _i64_ptr(shared), _i64_ptr(flags), n,
        _i64_ptr(row_ids) if row_ids is not None else None,
        names_blob, _i64_ptr(name_offs),
        ref_blob, _i64_ptr(ref_offs), len(ref_offs) - 1,
        tails_blob, _i64_ptr(tail_offs),
        ctypes.byref(out),
    )
    if ln < 0:
        return None
    data = ctypes.string_at(out, ln)
    lib.rkmh_buf_free(out)
    return data


class PackedReads:
    """Device-ready parse result: codes/lens arrays + raw record bytes.

    names/seqs/quals materialize lazily from the concatenated blobs —
    classify/stream/hash only touch names, so the per-record Python
    object cost is paid only where a command actually needs it
    (filter's record re-emission).
    """

    __slots__ = (
        "codes", "lens", "rec_offs",
        "_names_blob", "_name_offs", "_seqs_blob", "_seq_offs",
        "_quals_blob", "_qual_offs", "_names", "_seqs", "_quals",
    )

    def __init__(self, codes, lens, names_blob, name_offs, seqs_blob,
                 seq_offs, quals_blob, qual_offs, rec_offs=None):
        self.rec_offs = rec_offs  # record-start byte offsets (input index)
        self.codes = codes
        self.lens = lens
        self._names_blob = names_blob
        self._name_offs = name_offs
        self._seqs_blob = seqs_blob
        self._seq_offs = seq_offs
        self._quals_blob = quals_blob
        self._qual_offs = qual_offs
        self._names = self._seqs = self._quals = None

    def __len__(self):
        return len(self.lens)

    @property
    def names(self):
        if self._names is None:
            o = self._name_offs
            b = self._names_blob
            self._names = [b[o[i] : o[i + 1]].decode() for i in range(len(self))]
        return self._names

    @property
    def seqs(self):
        if self._seqs is None:
            o = self._seq_offs
            b = self._seqs_blob
            self._seqs = [b[o[i] : o[i + 1]] for i in range(len(self))]
        return self._seqs

    @property
    def quals(self):
        if self._quals is None:
            o = self._qual_offs
            b = self._quals_blob
            self._quals = [b[o[i] : o[i + 1]] or None for i in range(len(self))]
        return self._quals


def _batch_to_packed(lib, batch: _RkmhBatch) -> PackedReads:
    """Copy an owned _RkmhBatch into numpy arrays and free it."""
    try:
        n, pad = batch.n, batch.pad_len
        codes = np.ctypeslib.as_array(batch.codes, shape=(n, pad)).copy() if n else np.zeros((0, pad), np.uint8)
        lens = np.ctypeslib.as_array(batch.lens, shape=(n,)).copy() if n else np.zeros((0,), np.int32)
        name_offs = np.ctypeslib.as_array(batch.name_offs, shape=(n + 1,)).copy()
        seq_offs = np.ctypeslib.as_array(batch.seq_offs, shape=(n + 1,)).copy()
        qual_offs = np.ctypeslib.as_array(batch.qual_offs, shape=(n + 1,)).copy()
        rec_offs = (np.ctypeslib.as_array(batch.rec_offs, shape=(n,)).copy()
                    if n else np.zeros((0,), np.int64))
        names_blob = ctypes.string_at(batch.names, int(name_offs[n])) if n else b""
        seqs_blob = ctypes.string_at(batch.seqs, int(seq_offs[n])) if n else b""
        quals_blob = ctypes.string_at(batch.quals, int(qual_offs[n])) if n else b""
    finally:
        lib.rkmh_free(ctypes.byref(batch))
    return PackedReads(codes, lens, names_blob, name_offs, seqs_blob,
                       seq_offs, quals_blob, qual_offs, rec_offs)


def read_fastx_packed(path: str, granularity: int = 128) -> PackedReads | None:
    """Parse + pack one file natively; None if the library is unavailable."""
    lib = load()
    if lib is None:
        return None
    batch = _RkmhBatch()
    rc = lib.rkmh_read_fastx(
        os.fspath(path).encode(), granularity, ctypes.byref(batch)
    )
    if rc != 0:
        lib.rkmh_free(ctypes.byref(batch))
        raise OSError(f"native fastx parse failed (rc={rc}) for {path}")
    return _batch_to_packed(lib, batch)


class FastxStream:
    """Chunked native reader — the KSEQ_Reader::get_next_buffer equivalent
    (rkmh.cpp:950-959): bounded memory regardless of file size.  Each
    next_chunk(max_reads) returns a device-ready PackedReads of at most
    max_reads records, or None at end of file.
    """

    def __init__(self, path: str):
        lib = load()
        if lib is None:
            raise OSError("native io library unavailable")
        self._lib = lib
        self._h = lib.rkmh_stream_open(os.fspath(path).encode())
        if not self._h:
            raise OSError(f"cannot open {path}")
        self._path = path

    def next_chunk(self, max_reads: int, granularity: int = 128) -> PackedReads | None:
        if self._h is None:
            return None
        batch = _RkmhBatch()
        n = self._lib.rkmh_stream_next(
            self._h, max_reads, granularity, ctypes.byref(batch)
        )
        if n < 0:
            self._lib.rkmh_free(ctypes.byref(batch))
            raise OSError(f"native fastx stream failed (rc={n}) for {self._path}")
        if n == 0:
            self._lib.rkmh_free(ctypes.byref(batch))
            return None
        return _batch_to_packed(self._lib, batch)

    def seek(self, offset: int) -> None:
        """Reposition to an absolute uncompressed-stream byte offset (a
        record start from the .idx input index).  Raw lseek on plain
        files; callers gate on non-gzip inputs (gzseek decompresses
        forward, erasing the win)."""
        if self._h is None:
            raise OSError("stream closed")
        if self._lib.rkmh_stream_seek(self._h, int(offset)) != 0:
            raise OSError(f"seek({offset}) failed for {self._path}")

    def close(self):
        if self._h is not None:
            self._lib.rkmh_stream_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
