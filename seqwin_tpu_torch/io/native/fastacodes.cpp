// Native FASTA/gzip ingest (file -> base codes + record table) and the
// host-side canonical ntHash at sparse positions.
//
// Counterpart: seqwin_tpu/io/native/fastacodes.cpp, copied with only the
// parse and canon_at entry points the port uses. Base-code contract:
// A=0, C=1, G=2, T/U=3 case-insensitive, 255 otherwise (see
// seqwin_tpu_torch/ops/hashing.py CODE_TAB). Parsing semantics:
//   - plain or gzip input (gzip iff path ends with ".gz")
//   - trailing '\r' stripped per line; blank / whitespace-only lines skipped
//   - record id = first whitespace-delimited token after '>'
//   - intra-line ASCII whitespace removed from sequences
//   - sequence before any header -> error
//
// Exposed as a C ABI for ctypes. One handle per parsed file; the Python side
// copies the code buffer into numpy and frees the handle.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

#include <zlib.h>

namespace {

struct Parsed {
    std::vector<uint8_t> codes;          // concatenated base codes
    std::vector<uint64_t> offsets;       // per-record start offsets, n+1
    std::vector<std::string> ids;        // record ids
    std::string error;                   // non-empty on failure
};

constexpr uint8_t kInvalid = 255;

struct Tables {
    uint8_t code[256];
    bool ws[256];
    Tables() {
        std::memset(code, kInvalid, sizeof(code));
        code[uint8_t('A')] = 0; code[uint8_t('a')] = 0;
        code[uint8_t('C')] = 1; code[uint8_t('c')] = 1;
        code[uint8_t('G')] = 2; code[uint8_t('g')] = 2;
        code[uint8_t('T')] = 3; code[uint8_t('t')] = 3;
        code[uint8_t('U')] = 3; code[uint8_t('u')] = 3;
        // SEED_TAB's low-ASCII aliases (hashing_internals.hpp:136-169)
        code[1] = 3; code[3] = 2; code[4] = 0; code[5] = 0; code[7] = 1;
        std::memset(ws, 0, sizeof(ws));
        for (unsigned char c : {' ', '\t', '\n', '\r', '\f', '\v'}) ws[c] = true;
    }
};

const Tables kTab;

bool ends_with(const char* s, const char* suffix) {
    size_t n = std::strlen(s), m = std::strlen(suffix);
    return n >= m && std::strcmp(s + n - m, suffix) == 0;
}

// Parse one line [begin, end) (no terminator). Returns false on error.
bool handle_line(Parsed& p, const char* begin, const char* end, bool& have_record) {
    if (end > begin && end[-1] == '\r') --end;
    // skip blank / whitespace-only lines
    const char* q = begin;
    while (q < end && kTab.ws[(unsigned char)*q]) ++q;
    if (q == end) return true;

    if (*begin == '>') {
        p.offsets.push_back(p.codes.size());
        const char* id_end = begin + 1;
        while (id_end < end && !kTab.ws[(unsigned char)*id_end]) ++id_end;
        p.ids.emplace_back(begin + 1, id_end);
        have_record = true;
        return true;
    }
    if (!have_record) {
        p.error = "Invalid FASTA: sequence encountered before header";
        return false;
    }
    for (const char* c = begin; c < end; ++c) {
        unsigned char u = (unsigned char)*c;
        if (!kTab.ws[u]) p.codes.push_back(kTab.code[u]);
    }
    return true;
}

bool parse_buffer(Parsed& p, const char* data, size_t n) {
    bool have_record = false;
    const char* line = data;
    const char* end = data + n;
    while (line < end) {
        const char* nl = (const char*)std::memchr(line, '\n', (size_t)(end - line));
        const char* stop = nl ? nl : end;
        if (!handle_line(p, line, stop, have_record)) return false;
        line = nl ? nl + 1 : end;
    }
    p.offsets.push_back(p.codes.size());
    return true;
}

bool read_file(const char* path, std::string& out, std::string& err) {
    if (ends_with(path, ".gz")) {
        gzFile gz = gzopen(path, "rb");
        if (!gz) { err = "Unable to open gzip FASTA"; return false; }
        char buf[1 << 16];
        int n;
        while ((n = gzread(gz, buf, sizeof(buf))) > 0) out.append(buf, (size_t)n);
        bool ok = n == 0;
        if (!ok) {
            int errnum = 0;
            const char* msg = gzerror(gz, &errnum);
            err = std::string("gzip read error: ") + (msg ? msg : "unknown");
        }
        gzclose(gz);
        return ok;
    }
    FILE* f = std::fopen(path, "rb");
    if (!f) { err = "Unable to open FASTA"; return false; }
    std::fseek(f, 0, SEEK_END);
    long sz = std::ftell(f);
    std::fseek(f, 0, SEEK_SET);
    out.resize((size_t)sz);
    size_t got = sz ? std::fread(out.data(), 1, (size_t)sz, f) : 0;
    std::fclose(f);
    if ((long)got != sz) { err = "Short read"; return false; }
    return true;
}

}  // namespace

extern "C" {

// Bumped on ANY change to a function contract that keeps the symbol
// name/arity loadable: the Python loader rejects a cached .so whose version
// differs and rebuilds, closing the mtime-preserving-copy hole.
uint64_t sq_abi_version() { return 1; }

void* sq_parse(const char* path) {
    auto* p = new Parsed();
    std::string data;
    if (!read_file(path, data, p->error)) return p;  // error recorded
    if (data.empty()) { p->offsets.push_back(0); return p; }
    p->codes.reserve(data.size());
    parse_buffer(*p, data.data(), data.size());
    return p;
}

const char* sq_error(void* h) {
    auto* p = (Parsed*)h;
    return p->error.empty() ? nullptr : p->error.c_str();
}

uint64_t sq_n_records(void* h) { return ((Parsed*)h)->ids.size(); }
uint64_t sq_total_bases(void* h) { return ((Parsed*)h)->codes.size(); }
const uint8_t* sq_codes(void* h) { return ((Parsed*)h)->codes.data(); }
const uint64_t* sq_offsets(void* h) { return ((Parsed*)h)->offsets.data(); }
const char* sq_record_id(void* h, uint64_t i) { return ((Parsed*)h)->ids[i].c_str(); }
void sq_free(void* h) { delete (Parsed*)h; }

// Canonical ntHash at sparse positions (host path for irregular-window
// patches). The caller supplies the per-offset rotated seed tables
// fwd/rev[k][5] (`ops/host_hash.py::_tables`; column 4 = invalid -> 0), so
// this stays a pure table-XOR loop: the tables live in L1 and each position
// costs 2k XORs.
void sq_canon_at(
    const uint8_t* codes, const int64_t* pos, uint64_t n, uint64_t k,
    const uint64_t* fwd_tab, const uint64_t* rev_tab, uint64_t* out) {
    for (uint64_t i = 0; i < n; ++i) {
        const uint8_t* c = codes + pos[i];
        uint64_t f = 0, r = 0;
        for (uint64_t j = 0; j < k; ++j) {
            unsigned cc = c[j] & 63u;       // strip the record-start flag
            if (cc > 4u) cc = 4u;           // non-ACGT -> zero column
            f ^= fwd_tab[j * 5 + cc];
            r ^= rev_tab[j * 5 + cc];
        }
        out[i] = f + r;                     // u64 wrap == canonical add
    }
}

// Same over a 2-bit packed stream (4 bases/byte; positions must be valid
// ACGT, as in the NumPy version's contract).
void sq_canon_at_packed(
    const uint8_t* packed, const int64_t* pos, uint64_t n, uint64_t k,
    const uint64_t* fwd_tab, const uint64_t* rev_tab, uint64_t* out) {
    for (uint64_t i = 0; i < n; ++i) {
        uint64_t p = (uint64_t)pos[i];
        uint64_t f = 0, r = 0;
        for (uint64_t j = 0; j < k; ++j) {
            uint64_t q = p + j;
            unsigned cc = (packed[q >> 2] >> ((q & 3u) * 2u)) & 3u;
            f ^= fwd_tab[j * 5 + cc];
            r ^= rev_tab[j * 5 + cc];
        }
        out[i] = f + r;
    }
}

}  // extern "C"

