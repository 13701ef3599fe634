// Native FASTA/FASTQ parser + 2-bit packer (C ABI, loaded via ctypes).
//
// Replacement for the reference's kseq.hpp streaming parser and
// KSEQ_Reader buffered batch reader (SURVEY.md §2.1 rows 6-7): a streaming
// chunk API (`rkmh_stream_open` / `rkmh_stream_next` / `rkmh_stream_close`)
// parses gzip or plain files (detected by magic bytes like io/fastx.py)
// incrementally — bounded buffer, KSEQ_Reader::get_next_buffer semantics
// (rkmh.cpp:950-959, bufsize-1000 batches) — and emits the exact
// device-ready layout the JAX pipeline consumes per chunk:
//
//   codes [n, pad_len] uint8   2-bit codes A=0 C=1 G=2 T=3, invalid/pad=255/4
//   lens  [n] int32            true sequence lengths
//   names / seqs / quals       concatenated raw bytes + offset tables
//                              (seqs uppercased; quals empty for FASTA)
//
// `rkmh_read_fastx` (whole file in one batch) is a thin wrapper over the
// stream API, so there is exactly one parser.
//
// Semantics match rkmh_tpu.io.fastx exactly (the Python parser is the
// oracle): names are the header token up to the first whitespace, sequences
// are uppercased at parse time (rkmh.cpp:227 to_upper-at-parse), multi-line
// FASTA is concatenated, FASTQ is name/seq/+/qual.
//
// Build: g++ -O3 -march=native -shared -fPIC fastx_native.cpp -o librkmh_io.so -lz

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>
#include <string>
#include <zlib.h>

namespace {

struct Record {
    size_t name_off, name_len;
    size_t seq_off, seq_len;    // offsets into the uppercased seq blob
    size_t qual_off, qual_len;
    uint64_t src_off;           // record start ('>'/'@') in the
                                // UNCOMPRESSED input stream — the unit of
                                // the .idx input-index sidecar that lets
                                // distributed ranks seek to owned records
                                // instead of reparsing the whole input
};

// byte -> 2-bit code (case-insensitive); 4 = invalid base
uint8_t CODE_LUT[256];
uint8_t UPPER_LUT[256];
struct LutInit {
    LutInit() {
        for (int i = 0; i < 256; ++i) {
            CODE_LUT[i] = 4;
            UPPER_LUT[i] = (i >= 'a' && i <= 'z') ? uint8_t(i - 32) : uint8_t(i);
        }
        const char* b = "ACGT";
        for (int i = 0; i < 4; ++i) {
            CODE_LUT[(uint8_t)b[i]] = uint8_t(i);
            CODE_LUT[(uint8_t)(b[i] + 32)] = uint8_t(i);
        }
    }
} lut_init;

enum ParseStatus { P_OK, P_NEED_MORE, P_BAD, P_DONE };

struct ChunkBuild {
    std::vector<Record> recs;
    std::string names, seqs, quals;
};

// Parse one record from buf[pos..]. On P_OK, advances pos past the record
// and appends to `cb`. On P_NEED_MORE (record may continue past the buffer
// end and !eof), pos and cb are left untouched so the caller can refill and
// retry. P_DONE = only EOL/empty bytes remain at eof.
ParseStatus parse_one(const std::vector<uint8_t>& buf, size_t& pos, bool eof,
                      uint64_t base_off, ChunkBuild& cb) {
    size_t n = buf.size();
    size_t i = pos;
    auto skip_eol = [&](size_t& p) {
        while (p < n && (buf[p] == '\n' || buf[p] == '\r')) ++p;
    };
    auto line_end = [&](size_t p) {
        // two memchr scans (SIMD) preserve the original per-byte
        // semantics: a line ends at the first '\n' OR '\r' (CRLF and
        // lone-\r files both parse as before)
        if (p >= n) return n;
        const uint8_t* base = buf.data();
        const void* nl = memchr(base + p, '\n', n - p);
        size_t e = nl ? (size_t)((const uint8_t*)nl - base) : n;
        const void* cr = memchr(base + p, '\r', e - p);
        return cr ? (size_t)((const uint8_t*)cr - base) : e;
    };
    auto append_upper = [&](std::string& dst, size_t s, size_t e) {
        size_t old = dst.size();
        dst.resize(old + (e - s));
        char* d = &dst[old];
        const uint8_t* src = buf.data() + s;
        for (size_t m = 0; m < e - s; ++m) d[m] = (char)UPPER_LUT[src[m]];
    };

    skip_eol(i);
    if (i >= n) return eof ? P_DONE : P_NEED_MORE;
    uint8_t c = buf[i];
    if (c != '>' && c != '@') return P_BAD;
    bool fastq = (c == '@');
    size_t he = line_end(i);
    if (he >= n && !eof) return P_NEED_MORE;  // header may continue
    // name: token up to first whitespace after the marker
    size_t ns = i + 1, ne = ns;
    while (ne < he && buf[ne] != ' ' && buf[ne] != '\t') ++ne;

    size_t names0 = cb.names.size(), seqs0 = cb.seqs.size(), quals0 = cb.quals.size();
    Record r{};
    r.src_off = base_off + (uint64_t)i;  // i points at the '>'/'@' marker
    r.name_off = names0;
    r.name_len = ne - ns;
    cb.names.append((const char*)buf.data() + ns, ne - ns);
    i = he;
    skip_eol(i);

    auto rollback = [&]() {
        cb.names.resize(names0);
        cb.seqs.resize(seqs0);
        cb.quals.resize(quals0);
        return P_NEED_MORE;
    };

    r.seq_off = cb.seqs.size();
    if (fastq) {
        size_t se = line_end(i);
        if (se >= n && !eof) return rollback();
        append_upper(cb.seqs, i, se);
        i = se; skip_eol(i);
        r.qual_off = cb.quals.size();
        if (i >= n && !eof) return rollback();  // can't tell if '+' follows
        if (i < n && buf[i] == '+') {           // separator line
            size_t pe = line_end(i);
            if (pe >= n && !eof) return rollback();
            i = pe; skip_eol(i);
            size_t qe = line_end(i);
            if (qe >= n && !eof) return rollback();
            cb.quals.append((const char*)buf.data() + i, qe - i);
            i = qe;
        }
        r.qual_len = cb.quals.size() - r.qual_off;
    } else {
        for (;;) {
            if (i >= n) {
                if (!eof) return rollback();  // next line may be more seq
                break;
            }
            if (buf[i] == '>' || buf[i] == '@') break;
            size_t se = line_end(i);
            if (se >= n && !eof) return rollback();
            append_upper(cb.seqs, i, se);
            i = se; skip_eol(i);
        }
        r.qual_off = cb.quals.size();
        r.qual_len = 0;
    }
    r.seq_len = cb.seqs.size() - r.seq_off;
    cb.recs.push_back(r);
    pos = i;
    return P_OK;
}

}  // namespace

extern "C" {

typedef struct {
    int64_t n;
    int64_t pad_len;
    uint8_t* codes;      // n * pad_len
    int32_t* lens;       // n
    char* names;         // concatenated
    int64_t* name_offs;  // n + 1
    char* seqs;          // concatenated (uppercased)
    int64_t* seq_offs;   // n + 1
    char* quals;         // concatenated ('\0'-free; empty slices for FASTA)
    int64_t* qual_offs;  // n + 1
    int64_t* rec_offs;   // n: record-start byte offsets (uncompressed stream)
} RkmhBatch;

void rkmh_free(RkmhBatch* b) {
    if (!b) return;
    free(b->codes); free(b->lens);
    free(b->names); free(b->name_offs);
    free(b->seqs);  free(b->seq_offs);
    free(b->quals); free(b->qual_offs);
    free(b->rec_offs);
    memset(b, 0, sizeof(*b));
}

namespace {

// Pack a parsed chunk into the C-ABI batch. Returns 0 ok / 3 alloc failure.
int fill_batch(const ChunkBuild& cb, int64_t granularity, RkmhBatch* out) {
    const std::vector<Record>& recs = cb.recs;
    int64_t N = (int64_t)recs.size();
    int64_t max_len = 0;
    for (auto& r : recs) if ((int64_t)r.seq_len > max_len) max_len = r.seq_len;
    int64_t g = granularity > 0 ? granularity : 1;
    int64_t pad = ((max_len + g - 1) / g) * g;
    if (pad < g) pad = g;

    out->n = N;
    out->pad_len = pad;
    out->codes = (uint8_t*)malloc(size_t(N) * size_t(pad) + 1);
    out->lens = (int32_t*)malloc(size_t(N) * sizeof(int32_t) + 1);
    out->names = (char*)malloc(cb.names.size() ? cb.names.size() : 1);
    out->name_offs = (int64_t*)malloc((N + 1) * sizeof(int64_t));
    out->seqs = (char*)malloc(cb.seqs.size() ? cb.seqs.size() : 1);
    out->seq_offs = (int64_t*)malloc((N + 1) * sizeof(int64_t));
    out->quals = (char*)malloc(cb.quals.size() ? cb.quals.size() : 1);
    out->qual_offs = (int64_t*)malloc((N + 1) * sizeof(int64_t));
    out->rec_offs = (int64_t*)malloc(N * sizeof(int64_t) + 1);
    if (!out->codes || !out->lens || !out->names || !out->name_offs ||
        !out->seqs || !out->seq_offs || !out->quals || !out->qual_offs ||
        !out->rec_offs) {
        rkmh_free(out);
        return 3;
    }

    memset(out->codes, 255, size_t(N) * size_t(pad));  // PAD_CODE
    memcpy(out->names, cb.names.data(), cb.names.size());
    memcpy(out->seqs, cb.seqs.data(), cb.seqs.size());
    memcpy(out->quals, cb.quals.data(), cb.quals.size());

    int64_t noff = 0, soff = 0, qoff = 0;
    for (int64_t j = 0; j < N; ++j) {
        const Record& r = recs[j];
        out->name_offs[j] = noff; noff += (int64_t)r.name_len;
        out->seq_offs[j] = soff;  soff += (int64_t)r.seq_len;
        out->qual_offs[j] = qoff; qoff += (int64_t)r.qual_len;
        out->lens[j] = (int32_t)r.seq_len;
        out->rec_offs[j] = (int64_t)r.src_off;
        uint8_t* row = out->codes + size_t(j) * size_t(pad);
        const char* sp = cb.seqs.data() + r.seq_off;
        for (size_t p = 0; p < r.seq_len; ++p) row[p] = CODE_LUT[(uint8_t)sp[p]];
    }
    out->name_offs[N] = noff;
    out->seq_offs[N] = soff;
    out->qual_offs[N] = qoff;
    return 0;
}

}  // namespace

typedef struct RkmhStream {
    gzFile f;
    std::vector<uint8_t> buf;  // unparsed bytes
    size_t pos;                // parse cursor into buf
    uint64_t base_off;         // uncompressed-stream offset of buf[0]
    bool eof;
} RkmhStream;

RkmhStream* rkmh_stream_open(const char* path) {
    gzFile f = gzopen(path, "rb");  // transparently handles plain files too
    if (!f) return nullptr;
    gzbuffer(f, 1 << 20);
    RkmhStream* s = new RkmhStream();
    s->f = f;
    s->pos = 0;
    s->base_off = 0;
    s->eof = false;
    return s;
}

// Reposition to an absolute uncompressed-stream offset (an .idx sidecar
// record start).  Cheap raw lseek for plain files; for actual gzip data
// gzseek decompresses forward, so callers gate indexed seeking on
// uncompressed inputs.  Returns 0 ok / -1 failure.
int rkmh_stream_seek(RkmhStream* s, int64_t off) {
    if (!s || off < 0) return -1;
    if (gzseek(s->f, (z_off_t)off, SEEK_SET) < 0) return -1;
    s->buf.clear();
    s->pos = 0;
    s->base_off = (uint64_t)off;
    s->eof = false;
    return 0;
}

void rkmh_stream_close(RkmhStream* s) {
    if (!s) return;
    if (s->f) gzclose(s->f);
    delete s;
}

// Parse up to max_reads records into *out (caller rkmh_free's it).
// Returns the record count (0 = end of file), -1 on read error,
// -2 on malformed input, -3 on allocation failure.
int64_t rkmh_stream_next(RkmhStream* s, int64_t max_reads, int64_t granularity,
                         RkmhBatch* out) {
    memset(out, 0, sizeof(*out));
    if (!s) return -1;
    ChunkBuild cb;
    const size_t CHUNK = 1 << 22;
    // parse_one restarts the current record after every refill, so the
    // refill size doubles while one record keeps spanning the buffer —
    // a single R-byte record costs O(R log R) instead of O(R^2/CHUNK)
    size_t refill = CHUNK;
    while ((int64_t)cb.recs.size() < max_reads) {
        ParseStatus st = parse_one(s->buf, s->pos, s->eof, s->base_off, cb);
        if (st == P_OK) { refill = CHUNK; continue; }
        if (st == P_BAD) return -2;
        if (st == P_DONE) break;
        // P_NEED_MORE: drop consumed prefix, pull the next compressed chunk
        if (s->pos > 0) {
            s->buf.erase(s->buf.begin(), s->buf.begin() + (ptrdiff_t)s->pos);
            s->base_off += (uint64_t)s->pos;
            s->pos = 0;
        }
        size_t used = s->buf.size();
        size_t want = refill;
        s->buf.resize(used + want);
        size_t got_total = 0;
        while (got_total < want) {  // gzread caps each call at ~2^31
            unsigned ask = (unsigned)std::min<size_t>(want - got_total, 1u << 30);
            int got = gzread(s->f, s->buf.data() + used + got_total, ask);
            if (got < 0) return -1;
            got_total += (size_t)got;
            if (got == 0) { s->eof = true; break; }
        }
        s->buf.resize(used + got_total);
        if (refill < (size_t(1) << 31)) refill *= 2;
    }
    if (cb.recs.empty()) return 0;
    int rc = fill_batch(cb, granularity, out);
    if (rc != 0) return -3;
    return (int64_t)cb.recs.size();
}

// Format a batch of classify/stream output lines (rkmh.cpp:891-893 layout)
// in one call — replaces a per-read Python f-string loop (~0.5 us/line)
// with ~30 ns/line native code.  Inputs are the packed [3, B] int64 device
// result (best, shared, flags) plus the parser's zero-copy name blob:
//
//   line[i] = ref_key[best[i]] \t name[row_ids[i]] \t shared[i] tails[flags[i]]
//
// tails are the 8 precomputed "\t<s>[FAIL:...]" variants (flag bits
// diff_ok | depth_fail<<1 | match_fail<<2).  Returns the byte length and
// mallocs *out (caller frees via rkmh_buf_free); -1 on allocation failure.
int64_t rkmh_format_lines(const int64_t* best, const int64_t* shared,
                          const int64_t* flags, int64_t n,
                          const int64_t* row_ids,
                          const char* names_blob, const int64_t* name_offs,
                          const char* ref_blob, const int64_t* ref_offs,
                          int64_t num_refs,
                          const char* tails_blob, const int64_t* tail_offs,
                          char** out) {
    *out = nullptr;
    // upper-bound the buffer: per line = ref + name + 2 tabs + 20-digit
    // count + longest tail
    int64_t max_ref = 0, max_tail = 0;
    for (int64_t r = 0; r < num_refs; ++r) {
        int64_t l = ref_offs[r + 1] - ref_offs[r];
        if (l > max_ref) max_ref = l;
    }
    for (int t = 0; t < 8; ++t) {
        int64_t l = tail_offs[t + 1] - tail_offs[t];
        if (l > max_tail) max_tail = l;
    }
    int64_t names_total = 0;
    for (int64_t i = 0; i < n; ++i) {
        int64_t rid = row_ids ? row_ids[i] : i;
        names_total += name_offs[rid + 1] - name_offs[rid];
    }
    size_t cap = size_t(n) * size_t(max_ref + max_tail + 24) + size_t(names_total) + 1;
    char* buf = (char*)malloc(cap);
    if (!buf) return -1;
    char* p = buf;
    for (int64_t i = 0; i < n; ++i) {
        int64_t b = best[i];
        if (b < 0) b = 0;
        if (b >= num_refs) b = num_refs - 1;
        int64_t rl = ref_offs[b + 1] - ref_offs[b];
        memcpy(p, ref_blob + ref_offs[b], (size_t)rl); p += rl;
        *p++ = '\t';
        int64_t rid = row_ids ? row_ids[i] : i;
        int64_t nl = name_offs[rid + 1] - name_offs[rid];
        memcpy(p, names_blob + name_offs[rid], (size_t)nl); p += nl;
        *p++ = '\t';
        // itoa (shared is small and non-negative; handle negatives anyway)
        int64_t v = shared[i];
        if (v < 0) { *p++ = '-'; v = -v; }
        char tmp[24]; int ti = 0;
        do { tmp[ti++] = char('0' + (v % 10)); v /= 10; } while (v);
        while (ti) *p++ = tmp[--ti];
        int64_t f = flags[i] & 7;
        int64_t tl = tail_offs[f + 1] - tail_offs[f];
        memcpy(p, tails_blob + tail_offs[f], (size_t)tl); p += tl;
    }
    *out = buf;
    return (int64_t)(p - buf);
}

void rkmh_buf_free(char* p) { free(p); }

// Format a hash-dump batch: one "name\tv v v ...\n" line per row, the
// `hash` command's default output (space-joined masked u64 decimals —
// python's str() join was the throughput ceiling at ~5e5 values/s;
// this runs at ~5e7).  Returns byte length, mallocs *out (caller frees
// via rkmh_buf_free); -1 on allocation failure.
int64_t rkmh_format_hash_lines(const uint64_t* vals, const uint8_t* mask,
                               int64_t n_rows, int64_t width,
                               const char* names_blob,
                               const int64_t* name_offs,
                               char** out) {
    *out = nullptr;
    int64_t names_total = name_offs[n_rows] - name_offs[0];
    // per value: up to 20 digits + 1 separator; per row: name + tab + nl
    size_t cap = size_t(n_rows) * (size_t(width) * 21 + 2)
               + size_t(names_total) + 1;
    char* buf = (char*)malloc(cap);
    if (!buf) return -1;
    char* p = buf;
    char tmp[24];
    for (int64_t r = 0; r < n_rows; ++r) {
        int64_t nl = name_offs[r + 1] - name_offs[r];
        memcpy(p, names_blob + name_offs[r], (size_t)nl); p += nl;
        *p++ = '\t';
        const uint64_t* row = vals + r * width;
        const uint8_t* mrow = mask + r * width;
        bool first = true;
        for (int64_t j = 0; j < width; ++j) {
            if (!mrow[j]) continue;
            if (!first) *p++ = ' ';
            first = false;
            uint64_t v = row[j];
            char* t = tmp + sizeof(tmp);
            do { *--t = (char)('0' + v % 10); v /= 10; } while (v);
            size_t dl = (size_t)(tmp + sizeof(tmp) - t);
            memcpy(p, t, dl); p += dl;
        }
        *p++ = '\n';
    }
    *out = buf;
    return (int64_t)(p - buf);
}

// 2-bit-pack a [B, L] code matrix into the device wire format:
// packed [B, L/4] (4 bases/byte, base i at bits 2i%8) + vbits [B, L/8]
// (validity bitmask, little-endian bit order) — the exact layout of
// io/packing.pack_codes4, which numpy produces at ~150 MB/s via strided
// slicing; this loop runs at memory speed.  L % 8 == 0 (callers pad).
void rkmh_pack4(const uint8_t* codes, int64_t B, int64_t L,
                uint8_t* packed, uint8_t* vbits) {
    for (int64_t r = 0; r < B; ++r) {
        const uint8_t* row = codes + r * L;
        uint8_t* po = packed + r * (L / 4);
        uint8_t* vo = vbits + r * (L / 8);
        for (int64_t j = 0; j < L; j += 8) {
            uint8_t c0 = row[j],     c1 = row[j + 1],
                    c2 = row[j + 2], c3 = row[j + 3],
                    c4 = row[j + 4], c5 = row[j + 5],
                    c6 = row[j + 6], c7 = row[j + 7];
            uint8_t v = (uint8_t)((c0 < 4) | ((c1 < 4) << 1) |
                                  ((c2 < 4) << 2) | ((c3 < 4) << 3) |
                                  ((c4 < 4) << 4) | ((c5 < 4) << 5) |
                                  ((c6 < 4) << 6) | ((c7 < 4) << 7));
            // invalid bases pack as 0 (consumers only test validity)
            po[0] = (uint8_t)(((c0 < 4) ? c0 : 0) |
                              (((c1 < 4) ? c1 : 0) << 2) |
                              (((c2 < 4) ? c2 : 0) << 4) |
                              (((c3 < 4) ? c3 : 0) << 6));
            po[1] = (uint8_t)(((c4 < 4) ? c4 : 0) |
                              (((c5 < 4) ? c5 : 0) << 2) |
                              (((c6 < 4) ? c6 : 0) << 4) |
                              (((c7 < 4) ? c7 : 0) << 6));
            po += 2;
            *vo++ = v;
        }
    }
}

// Parse one whole FASTA/FASTQ file into a single packed batch.
// Returns 0 on success, nonzero on error (1 io, 2 malformed, 3 alloc).
int rkmh_read_fastx(const char* path, int64_t granularity, RkmhBatch* out) {
    memset(out, 0, sizeof(*out));
    RkmhStream* s = rkmh_stream_open(path);
    if (!s) return 1;
    int64_t n = rkmh_stream_next(s, INT64_MAX, granularity, out);
    rkmh_stream_close(s);
    if (n == -1) return 1;
    if (n == -2) return 2;
    if (n == -3) return 3;
    if (n == 0) {
        // empty file: emit a valid 0-record batch (offsets arrays of size 1)
        ChunkBuild cb;
        return fill_batch(cb, granularity, out);
    }
    return 0;
}

}  // extern "C"
