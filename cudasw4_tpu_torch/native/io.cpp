// Native IO hot paths: FASTA/FASTQ(.gz) parsing+encoding and tile packing
// (the port's copy of cudasw4_tpu/native/io.cpp).
//
// Plays the role of the reference's native IO layer (its kseqpp streaming
// reader, ConvertAA_20 encoding and the makedb parse/pad hot loop) as a
// small C++17 shared library driven from Python via ctypes.  Semantics
// match the pure-Python paths in db/fasta.py, db/packing.py and
// ops/pack5.py byte for byte (tests/test_torch_native.py).
//
// Build (native/__init__.py does it at first use, into build/native/):
//   g++ -O3 -std=c++17 -shared -fPIC io.cpp -o libtpusw_io.so -lz

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

#include <zlib.h>

namespace {

constexpr int8_t kUnknown = 20;

// NCBI order A R N D C Q E G H I L K M F P S T W Y V, everything else -> 20.
struct EncodeTable {
    int8_t table[256];
    EncodeTable() {
        for (int i = 0; i < 256; i++) table[i] = kUnknown;
        const char* aas = "ARNDCQEGHILKMFPSTWYV";
        for (int i = 0; aas[i]; i++) table[(unsigned char)aas[i]] = (int8_t)i;
    }
};
const EncodeTable kEncode;

template <class T>
struct Buf {
    T* data = nullptr;
    int64_t size = 0;
    int64_t cap = 0;
    void reserve(int64_t n) {
        if (n <= cap) return;
        int64_t ncap = cap ? cap : 4096;
        while (ncap < n) ncap += ncap / 2;
        data = (T*)realloc(data, ncap * sizeof(T));
        cap = ncap;
    }
    void push(const T* src, int64_t n) {
        reserve(size + n);
        memcpy(data + size, src, n * sizeof(T));
        size += n;
    }
    void push1(T v) {
        reserve(size + 1);
        data[size++] = v;
    }
};

struct ParseResult {
    Buf<int8_t> chars;        // encoded, each sequence padded to x4
    Buf<int64_t> offsets;     // n+1
    Buf<int32_t> lengths;     // n
    Buf<char> headers;        // concatenated
    Buf<int64_t> headerOffsets;  // n+1
};

struct StreamState {
    gzFile f = nullptr;
    std::string pending_header;  // header of the next (unstarted) record
    bool has_pending = false;
    bool pending_fastq = false;
    bool eof = false;
};

// Parse records from f into res.  Stops at a record boundary once at
// least max_chars padded chars were produced (max_chars < 0: parse all).
// Returns false on a malformed input (errbuf filled).
bool parse_records(gzFile f, StreamState* st, ParseResult* res,
                   int64_t max_chars, char* errbuf, int errlen) {
    std::vector<char> line(1 << 16);
    std::string seq;
    seq.reserve(1 << 16);
    bool have_record = false;
    bool fastq = false;
    int64_t qual_needed = 0;

    if (st && st->has_pending) {
        res->headers.push(st->pending_header.data(),
                          (int64_t)st->pending_header.size());
        res->headerOffsets.push1(res->headers.size);
        have_record = true;
        fastq = st->pending_fastq;
        st->has_pending = false;
    }

    auto flush_record = [&]() {
        if (!have_record) return;
        int64_t len = (int64_t)seq.size();
        int64_t padded = (len + 3) / 4 * 4;
        res->chars.reserve(res->chars.size + padded);
        int8_t* dst = res->chars.data + res->chars.size;
        const unsigned char* src = (const unsigned char*)seq.data();
        for (int64_t i = 0; i < len; i++) dst[i] = kEncode.table[src[i]];
        for (int64_t i = len; i < padded; i++) dst[i] = kUnknown;
        res->chars.size += padded;
        res->offsets.push1(res->chars.size);
        res->lengths.push1((int32_t)len);
        seq.clear();
        have_record = false;
    };

    while (gzgets(f, line.data(), (int)line.size())) {
        int64_t n = (int64_t)strlen(line.data());
        // handle lines longer than the buffer
        std::string full(line.data(), n);
        while (n > 0 && full.back() != '\n' && !gzeof(f)) {
            if (!gzgets(f, line.data(), (int)line.size())) break;
            n = (int64_t)strlen(line.data());
            full.append(line.data(), n);
        }
        while (!full.empty() && (full.back() == '\n' || full.back() == '\r'))
            full.pop_back();
        if (qual_needed > 0) {
            qual_needed -= (int64_t)full.size();
            if (qual_needed <= 0) {
                flush_record();
                fastq = false;
            }
            continue;
        }
        if (full.empty()) continue;
        char lead = full[0];
        if (lead == '>' || lead == '@') {
            flush_record();
            if (st && max_chars >= 0 && res->chars.size >= max_chars) {
                // Budget reached: park this header for the next call.
                st->pending_header.assign(full.data() + 1, full.size() - 1);
                st->pending_fastq = (lead == '@');
                st->has_pending = true;
                return true;
            }
            res->headers.push(full.data() + 1, (int64_t)full.size() - 1);
            res->headerOffsets.push1(res->headers.size);
            have_record = true;
            fastq = (lead == '@');
        } else if (lead == '+' && fastq) {
            qual_needed = (int64_t)seq.size();
            if (qual_needed == 0) {  // empty sequence: flush immediately
                flush_record();
                fastq = false;
            }
        } else {
            if (!have_record) {
                snprintf(errbuf, errlen, "sequence data before first header");
                return false;
            }
            seq.append(full);
        }
    }
    flush_record();
    if (st) st->eof = true;
    return true;
}

}  // namespace

extern "C" {

void tpusw_free_result(void* h);

// Opaque handle API so Python can copy the arrays into numpy and free once.
void* tpusw_parse_fasta(const char* path, char* errbuf, int errlen) {
    gzFile f = gzopen(path, "rb");
    if (!f) {
        snprintf(errbuf, errlen, "cannot open %s", path);
        return nullptr;
    }
    gzbuffer(f, 1 << 20);

    auto* res = new ParseResult();
    res->offsets.push1(0);
    res->headerOffsets.push1(0);
    if (!parse_records(f, nullptr, res, -1, errbuf, errlen)) {
        gzclose(f);
        delete res;
        return nullptr;
    }
    gzclose(f);
    return res;
}

// ----- Streaming variant: bounded-memory parse for huge inputs -----
// (the reference parses into FileBackedUVectors for the same reason,
// the reference's src/makedb.cpp:80-133)

void* tpusw_stream_open(const char* path, char* errbuf, int errlen) {
    gzFile f = gzopen(path, "rb");
    if (!f) {
        snprintf(errbuf, errlen, "cannot open %s", path);
        return nullptr;
    }
    gzbuffer(f, 1 << 20);
    auto* st = new StreamState();
    st->f = f;
    return st;
}

// Parse the next batch of complete records totalling >= max_chars padded
// chars (or until EOF).  Returns a result handle (use the tpusw_* batch
// accessors + tpusw_free_result), or nullptr at EOF / on error
// (errbuf[0] != 0 distinguishes the error case).
void* tpusw_stream_next(void* handle, int64_t max_chars, char* errbuf,
                        int errlen) {
    auto* st = (StreamState*)handle;
    errbuf[0] = 0;
    if (st->eof && !st->has_pending) return nullptr;
    auto* res = new ParseResult();
    res->offsets.push1(0);
    res->headerOffsets.push1(0);
    if (!parse_records(st->f, st, res, max_chars, errbuf, errlen)) {
        delete res;
        return nullptr;
    }
    if (res->lengths.size == 0) {
        tpusw_free_result(res);
        return nullptr;
    }
    return res;
}

void tpusw_stream_close(void* handle) {
    auto* st = (StreamState*)handle;
    if (st->f) gzclose(st->f);
    delete st;
}

int64_t tpusw_num_sequences(void* h) { return ((ParseResult*)h)->lengths.size; }
int64_t tpusw_num_chars(void* h) { return ((ParseResult*)h)->chars.size; }
int64_t tpusw_headers_size(void* h) { return ((ParseResult*)h)->headers.size; }
const int8_t* tpusw_chars(void* h) { return ((ParseResult*)h)->chars.data; }
const int64_t* tpusw_offsets(void* h) { return ((ParseResult*)h)->offsets.data; }
const int32_t* tpusw_lengths(void* h) { return ((ParseResult*)h)->lengths.data; }
const char* tpusw_headers(void* h) { return ((ParseResult*)h)->headers.data; }
const int64_t* tpusw_header_offsets(void* h) {
    return ((ParseResult*)h)->headerOffsets.data;
}

void tpusw_free_result(void* h) {
    auto* res = (ParseResult*)h;
    free(res->chars.data);
    free(res->offsets.data);
    free(res->lengths.data);
    free(res->headers.data);
    free(res->headerOffsets.data);
    delete res;
}

// Pack sequences [start, stop) of a length-sorted db into position-major
// tiles [T, L, NS] (padded with `pad`; kUnknown classic, a dedicated
// padding code in full-blosum mode).  out must hold T*L*NS bytes,
// out_idx/out_len T*NS elements.  NS must be a multiple of SB (64), the
// blocked walk's subject step — callers (native/__init__.py) enforce it.
//
// The layout is a transpose (sequences are position-contiguous, tiles are
// subject-contiguous per position), so a naive per-sequence scatter
// writes one byte per cache line (stride NS = 4096) and runs at
// ~60 MB/s.  Packing instead walks L1-resident SB x PB blocks: read SB
// sequences' next PB bytes contiguously, transpose in the block, write
// PB position rows of SB contiguous bytes.  Sequences are length-sorted,
// so position blocks past the block's longest sequence are pure padding
// already covered by the memset and are skipped.
void tpusw_pack_bucket(const int8_t* chars, const int64_t* offsets,
                       const int32_t* lengths, int64_t start, int64_t stop,
                       int64_t L, int64_t NS, int8_t* out, int32_t* out_idx,
                       int32_t* out_len, int8_t pad) {
    int64_t count = stop - start;
    int64_t T = (count + NS - 1) / NS;
    memset(out, pad, (size_t)(T * L * NS));
    constexpr int64_t SB = 64, PB = 64;
    int8_t buf[SB][PB];
    for (int64_t t = 0; t < T; t++) {
        int8_t* tile = out + t * L * NS;
        for (int64_t s0 = 0; s0 < NS; s0 += SB) {
            int64_t nsub = SB;  // valid subjects in this block
            if (t * NS + s0 >= count) nsub = 0;
            else if (t * NS + s0 + SB > count) nsub = count - t * NS - s0;
            int64_t maxlen = 0;
            for (int64_t s = 0; s < nsub; s++) {
                int64_t g = start + t * NS + s0 + s;
                out_idx[t * NS + s0 + s] = (int32_t)g;
                out_len[t * NS + s0 + s] = lengths[g];
                if (lengths[g] > maxlen) maxlen = lengths[g];
            }
            if (maxlen > L) maxlen = L;  // callers guarantee len <= L
            for (int64_t s = nsub; s < SB; s++) {
                out_idx[t * NS + s0 + s] = -1;
                out_len[t * NS + s0 + s] = 0;
            }
            for (int64_t j0 = 0; j0 < maxlen; j0 += PB) {
                int64_t pb = maxlen - j0 < PB ? maxlen - j0 : PB;
                for (int64_t s = 0; s < nsub; s++) {
                    int64_t g = start + t * NS + s0 + s;
                    int64_t have = (int64_t)lengths[g] - j0;
                    if (have > pb) have = pb;
                    if (have > 0)
                        memcpy(buf[s], chars + offsets[g] + j0,
                               (size_t)have);
                    else
                        have = 0;
                    if (have < PB)
                        memset(buf[s] + have, pad,
                               (size_t)(PB - have));
                }
                for (int64_t s = nsub; s < SB; s++)
                    memset(buf[s], pad, PB);
                for (int64_t p = 0; p < pb; p++) {
                    int8_t* dst = tile + (j0 + p) * NS + s0;
                    for (int64_t s = 0; s < SB; s++) dst[s] = buf[s][p];
                }
            }
        }
    }
}

// Transfer-pack codecs (ops/pack5.py analog, the host-side hot loop of
// streaming-mode preparation).  rows x E int8 codes -> rows x W int32
// words; returns 0, or -1 on an out-of-range code (caller falls back to
// the checked numpy path's error).  b32: 6 codes x 5 bits.  b21: 7
// base-21 digits (21^7 < 2^31).  The numpy Horner pack measures
// ~18 MB/s; this loop runs at memory speed, which matters once per
// database at trembl scale (tens of GB).
int tpusw_pack_b32(const int8_t* codes, int64_t rows, int64_t E,
                   int32_t* out) {
    int64_t W = (E + 5) / 6;
    for (int64_t r = 0; r < rows; r++) {
        const int8_t* row = codes + r * E;
        int32_t* orow = out + r * W;
        for (int64_t w = 0; w < W; w++) {
            int64_t base = w * 6;
            int64_t m = E - base < 6 ? E - base : 6;
            int32_t acc = 0;
            for (int64_t k = 0; k < m; k++) {
                int8_t c = row[base + k];
                if (c < 0 || c > 31) return -1;
                acc |= (int32_t)c << (5 * k);
            }
            orow[w] = acc;
        }
    }
    return 0;
}

int tpusw_pack_b21(const int8_t* codes, int64_t rows, int64_t E,
                   int32_t* out) {
    static const int32_t pow21[7] = {1, 21, 441, 9261, 194481, 4084101,
                                     85766121};
    int64_t W = (E + 6) / 7;
    for (int64_t r = 0; r < rows; r++) {
        const int8_t* row = codes + r * E;
        int32_t* orow = out + r * W;
        for (int64_t w = 0; w < W; w++) {
            int64_t base = w * 7;
            int64_t m = E - base < 7 ? E - base : 7;
            int32_t acc = 0;
            for (int64_t k = 0; k < m; k++) {
                int8_t c = row[base + k];
                if (c < 0 || c > 20) return -1;
                acc += (int32_t)c * pow21[k];
            }
            orow[w] = acc;
        }
    }
    return 0;
}

}  // extern "C"
