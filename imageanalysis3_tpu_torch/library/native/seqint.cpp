// 2-bit DNA k-mer packing — the framework's native hot kernel for
// off-target count-table construction.
//
// Behavior target: reference library_tools/C_Tools/seqint.pyx:1-56
// (seq2Int / seq2Int_rc LUT packing: A=0, C=1, G=2, T=3; reverse
// complement packs the complement LUT walking the sequence backwards).
// This C++ version adds the batch kernel the reference lacks: one pass
// over a genome-scale sequence emitting every k-mer's forward and
// reverse-complement code (rolling update, O(1) per position).
//
// Built as a plain shared library (no pybind11 in this image); consumed
// via ctypes from imageanalysis3_tpu_torch.library.seqint (the port's copy
// of imageanalysis3_tpu/library/native/seqint.cpp).

#include <cstdint>
#include <cstddef>

extern "C" {

static inline uint64_t base_code(unsigned char b) {
    switch (b) {
        case 'C': case 'c': return 1;
        case 'G': case 'g': return 2;
        case 'T': case 't': return 3;
        default: return 0;               // A / a / anything else -> 0
    }
}

static inline uint64_t base_code_rc(unsigned char b) {
    switch (b) {
        case 'A': case 'a': return 3;
        case 'C': case 'c': return 2;
        case 'G': case 'g': return 1;
        default: return 0;               // T / t / anything else -> 0
    }
}

// Pack one sequence (reference seq2Int).
uint64_t seq2int(const char* seq, int64_t n) {
    uint64_t v = 0;
    for (int64_t i = 0; i < n; ++i) {
        v = (v << 2) | base_code((unsigned char)seq[i]);
    }
    return v;
}

// Pack the reverse complement (reference seq2Int_rc).
uint64_t seq2int_rc(const char* seq, int64_t n) {
    uint64_t v = 0;
    for (int64_t i = 0; i < n; ++i) {
        v = (v << 2) | base_code_rc((unsigned char)seq[n - 1 - i]);
    }
    return v;
}

// All k-mers of `seq` in one rolling pass: out_fw/out_rc get n-word+1
// codes each (out_rc may be null).  Returns the number of k-mers.
int64_t seq_to_kmers(const char* seq, int64_t n, int word,
                     uint64_t* out_fw, uint64_t* out_rc) {
    if (n < word || word <= 0 || word > 32) return 0;
    const uint64_t mask = (word == 32) ? ~0ULL
                                       : ((1ULL << (2 * word)) - 1);
    const int shift_rc = 2 * (word - 1);
    uint64_t fw = 0, rc = 0;
    for (int64_t i = 0; i < n; ++i) {
        fw = ((fw << 2) | base_code((unsigned char)seq[i])) & mask;
        rc = (rc >> 2)
           | (base_code_rc((unsigned char)seq[i]) << shift_rc);
        int64_t k = i - word + 1;
        if (k >= 0) {
            out_fw[k] = fw;
            if (out_rc) out_rc[k] = rc;
        }
    }
    return n - word + 1;
}

// Scatter-add k-mer counts into a dense uint16 table with saturation —
// the count-table construction inner loop (reference countTable.complete,
// library_tools/design.py:104-130, without the np.unique detour).
void count_kmers_dense(const uint64_t* kmers, int64_t n,
                       uint16_t* table, uint64_t table_size) {
    for (int64_t i = 0; i < n; ++i) {
        uint64_t k = kmers[i];
        if (k < table_size && table[k] != 0xFFFF) table[k] += 1;
    }
}

}  // extern "C"
