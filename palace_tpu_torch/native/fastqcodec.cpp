// fastqcodec — native FASTQ → base-code batch loader for the eref stage.
//
// The data-loading half of the reference's extract_ref.cpp read_fastq
// (:905-1008): the reference interleaves FASTQ parsing with k-mer hashing
// in pthread byte-range shards; here the hashing lives on the device
// (palace_tpu_torch/ops/count_table.py) and this library only has to turn
// FASTQ text into fixed-shape (batch, maxlen) uint8 code matrices as fast
// as the disk/zlib can feed them.  gzip and plain files are both handled
// via zlib's gzread (transparent for uncompressed input).
//
// Semantics shared with the Python reader (palace_tpu_torch/search/eref.py
// _py_read_batches):
//   * base codes A=0 C=1 G=2 T=3 (case-insensitive), anything else 4;
//     rows padded with 4 (code 4 invalidates any k-mer window over it).
//   * 4-line FASTQ records (@hdr / seq / + / qual), CRLF tolerated.
//   * deterministic down-sampling: read index kept iff
//     (idx * 2654435761) % 100 < ratio   (ratio >= 100 keeps all).
//   * reads longer than maxlen are emitted as multiple rows with a
//     k-1 overlap, so the k-mer multiset is exactly preserved.
//
// Built with g++ at first use by palace_tpu_torch/native/_build.py and
// loaded via ctypes from palace_tpu_torch/io/fastq_native.py.

#include <zlib.h>

#include <cstdint>
#include <cstring>
#include <new>
#include <vector>

namespace {

constexpr size_t CHUNK = 1u << 22;  // 4 MB read chunks

uint8_t LUT[256];
struct LutInit {
    LutInit() {
        memset(LUT, 4, sizeof(LUT));
        LUT[(unsigned)'A'] = LUT[(unsigned)'a'] = 0;
        LUT[(unsigned)'C'] = LUT[(unsigned)'c'] = 1;
        LUT[(unsigned)'G'] = LUT[(unsigned)'g'] = 2;
        LUT[(unsigned)'T'] = LUT[(unsigned)'t'] = 3;
    }
} lut_init;

struct Handle {
    gzFile f = nullptr;
    std::vector<char> buf;
    size_t pos = 0, len = 0;
    int phase = 0;  // 0=@hdr 1=seq 2=+ 3=qual (line within the record)
    std::vector<uint8_t> seq;       // codes of the record being parsed
    std::vector<uint8_t> pending;   // long-read rows not yet emitted
    size_t pend_off = 0;
    uint64_t idx = 0;               // records seen (downsampling index)
    int ratio = 100;
    int k = 32;
    bool eof = false;
    bool err = false;   // zlib/IO error (NOT the same as EOF)
    bool last_cr = false;  // last raw seq byte was '\r' (CRLF strip)
};

bool gz_failed(gzFile f, int n) {
    // corrupt/truncated gzip: gzread returns -1 (data error) or a short
    // count followed by 0 with gzerror != Z_OK (premature EOF).
    if (n < 0) return true;
    if (n == 0) {
        int errnum = Z_OK;
        gzerror(f, &errnum);
        if (errnum != Z_OK && errnum != Z_STREAM_END) return true;
        // plain-file premature truncation cannot be detected here;
        // gzeof(f)==0 at n==0 also indicates an error path
        if (!gzeof(f)) return true;
    }
    return false;
}

bool fill(Handle* h) {
    int n = gzread(h->f, h->buf.data(), (unsigned)h->buf.size());
    if (gz_failed(h->f, n)) {
        h->err = true;
        h->eof = true;
        return false;
    }
    if (n == 0) {
        h->eof = true;
        return false;
    }
    h->pos = 0;
    h->len = (size_t)n;
    return true;
}

bool keep_read(uint64_t idx, int ratio) {
    if (ratio >= 100) return true;
    return (idx * 2654435761ull) % 100ull < (uint64_t)ratio;
}

// Append one read's codes as >=1 rows of width maxlen (k-1 overlap
// between consecutive rows of the same read) into out; overflow past
// `batch` rows goes to h->pending.  Returns the updated row count.
int emit_read(Handle* h, const uint8_t* codes, size_t n, uint8_t* out,
              int batch, int maxlen, int row) {
    if (n == 0) {  // empty read: one all-pad row (Python-parity)
        if (row < batch) {
            memset(out + (size_t)row * (size_t)maxlen, 4, (size_t)maxlen);
            return row + 1;
        }
        size_t old = h->pending.size();
        h->pending.resize(old + (size_t)maxlen);
        memset(h->pending.data() + old, 4, (size_t)maxlen);
        return row;
    }
    size_t stride = (size_t)maxlen - (size_t)(h->k - 1);
    if ((int)n <= maxlen) stride = n;  // single row
    for (size_t off = 0; off < n; off += stride) {
        size_t m = n - off;
        if (m > (size_t)maxlen) m = (size_t)maxlen;
        if (row < batch) {
            uint8_t* dst = out + (size_t)row * (size_t)maxlen;
            memcpy(dst, codes + off, m);
            memset(dst + m, 4, (size_t)maxlen - m);
            ++row;
        } else {
            size_t old = h->pending.size();
            h->pending.resize(old + (size_t)maxlen);
            memcpy(h->pending.data() + old, codes + off, m);
            memset(h->pending.data() + old + m, 4, (size_t)maxlen - m);
        }
        if (m < (size_t)maxlen) break;  // final (short) row of this read
        if (off + m >= n) break;
    }
    return row;
}

}  // namespace

extern "C" {

void* fqc_open(const char* path, int ratio, int k) {
    gzFile f = gzopen(path, "rb");
    if (!f) return nullptr;
    gzbuffer(f, 1u << 20);
    Handle* h = new (std::nothrow) Handle();
    if (!h) {
        gzclose(f);
        return nullptr;
    }
    h->f = f;
    h->buf.resize(CHUNK);
    h->ratio = ratio;
    h->k = k < 1 ? 1 : k;
    h->seq.reserve(512);
    return h;
}

// Fill out (batch*maxlen bytes, row-major) with code rows.  Returns the
// number of rows written; 0 means EOF (all input consumed and emitted);
// -1 on parse/IO state errors.
long fqc_next_batch(void* vh, uint8_t* out, int batch, int maxlen) {
    Handle* h = (Handle*)vh;
    if (!h || batch <= 0 || maxlen < h->k) return -1;
    int row = 0;

    // Drain rows buffered from a long read that overflowed last call.
    size_t pend_rows = (h->pending.size() - h->pend_off) / (size_t)maxlen;
    while (pend_rows > 0 && row < batch) {
        memcpy(out + (size_t)row * maxlen, h->pending.data() + h->pend_off,
               (size_t)maxlen);
        h->pend_off += (size_t)maxlen;
        --pend_rows;
        ++row;
    }
    if (h->pend_off >= h->pending.size()) {
        h->pending.clear();
        h->pend_off = 0;
    }
    if (row >= batch) return row;

    while (!h->eof || h->pos < h->len) {
        if (h->pos >= h->len && !fill(h)) break;
        while (h->pos < h->len) {
            const char* start = h->buf.data() + h->pos;
            const char* nl =
                (const char*)memchr(start, '\n', h->len - h->pos);
            size_t seg = nl ? (size_t)(nl - start) : h->len - h->pos;
            if (h->phase == 1) {  // sequence line (may span chunks)
                size_t old = h->seq.size();
                h->seq.resize(old + seg);
                for (size_t i = 0; i < seg; ++i)
                    h->seq[old + i] = LUT[(unsigned char)start[i]];
                if (seg) h->last_cr = start[seg - 1] == '\r';
            }
            h->pos += seg + (nl ? 1 : 0);
            if (!nl) break;  // need more data for this line
            // line complete
            if (h->phase == 1) {
                if (h->last_cr && !h->seq.empty()) h->seq.pop_back();
                h->last_cr = false;
                if (keep_read(h->idx, h->ratio))
                    row = emit_read(h, h->seq.data(), h->seq.size(), out,
                                    batch, maxlen, row);
                ++h->idx;
                h->seq.clear();
            }
            h->phase = (h->phase + 1) & 3;
            if (row >= batch) return row;
        }
    }
    // EOF: flush a final record whose qual line lacked a newline —
    // sequence lines were already handled at their newline; a seq line
    // with no trailing newline at EOF:
    if (h->phase == 1 && !h->seq.empty()) {
        if (h->last_cr) h->seq.pop_back();
        h->last_cr = false;
        if (keep_read(h->idx, h->ratio))
            row = emit_read(h, h->seq.data(), h->seq.size(), out, batch,
                            maxlen, row);
        ++h->idx;
        h->seq.clear();
        h->phase = 2;
    }
    if (h->err) return -1;
    return row;
}

void fqc_close(void* vh) {
    Handle* h = (Handle*)vh;
    if (!h) return;
    if (h->f) gzclose(h->f);
    delete h;
}

// Total sequence bases (sum of seq-line lengths) — the downsample-ratio
// scan (reference cal_sam_ratio, extract_ref.cpp:1124-1148) without
// Python-side line iteration.  Returns -1 on open failure.
double fqc_count_bases(const char* path) {
    gzFile f = gzopen(path, "rb");
    if (!f) return -1.0;
    gzbuffer(f, 1u << 20);
    std::vector<char> buf(CHUNK);
    double total = 0.0;
    int phase = 0;
    size_t line_len = 0;
    bool cr = false;
    for (;;) {
        int n = gzread(f, buf.data(), (unsigned)buf.size());
        if (gz_failed(f, n)) {  // corrupt gzip → error, not a short count
            gzclose(f);
            return -1.0;
        }
        if (n == 0) break;
        size_t pos = 0, len = (size_t)n;
        while (pos < len) {
            const char* start = buf.data() + pos;
            const char* nl = (const char*)memchr(start, '\n', len - pos);
            size_t seg = nl ? (size_t)(nl - start) : len - pos;
            if (phase == 1) {
                line_len += seg;
                cr = seg ? start[seg - 1] == '\r' : cr;
            }
            pos += seg + (nl ? 1 : 0);
            if (!nl) break;
            if (phase == 1) {
                total += (double)(line_len - (cr ? 1 : 0));
                line_len = 0;
                cr = false;
            }
            phase = (phase + 1) & 3;
        }
    }
    if (phase == 1 && line_len) total += (double)(line_len - (cr ? 1 : 0));
    gzclose(f);
    return total;
}

}  // extern "C"
