// Fused text featurization: tokenize -> stop-filter -> hash -> count in one
// C++ sweep over raw UTF-8 document bytes.
//
// The Python stage chain (feature/text.py: Tokenizer -> StopWordsRemover ->
// HashingTF) materializes every token as a Python str; at corpus scale the
// host becomes the bottleneck while the TPU idles (the reference ran this
// as distributed JVM work, TextFeaturizer.scala:230-290).  This kernel
// replicates the DEFAULT chain semantics exactly for pure-ASCII documents:
//
//   * whitespace-split identical to Python re.split(r"\s+") on ASCII text:
//     separators are { \t \n \v \f \r space \x1c \x1d \x1e \x1f } (the
//     ASCII subset of unicode \s); empty tokens are dropped.
//   * optional ASCII lowercasing (== str.lower() for ASCII).
//   * optional stop-word removal; membership may be tested on a lowercased
//     copy (lower_for_stop) while the token itself stays unmodified, which
//     mirrors `(t if cs else t.lower()) not in stop`.
//   * zlib crc32 (== feature/hashing.py stable_hash) modulo num_features,
//     per-document sorted-unique slot counts (== np.unique semantics).
//
// Documents containing any byte >= 0x80 are NOT processed (status=1): the
// caller recomputes those rows through the Python path, because unicode
// whitespace/lowercasing tables belong in Python, not here.  One C++
// entry point per concern, C ABI, loaded via ctypes.
//
// The port's copy of the JAX package's source (the same code, so both
// packages hash a document to the same row), built on its own into
// libmmltext-<digest>.so and linked with zlib alone
// (mmlspark_tpu_torch/native_loader.py): a host without the image codecs'
// headers still builds it.

#include <zlib.h>

#include <cstdint>

#include <algorithm>
#include <cstdlib>
#include <cstring>
#include <string>
#include <unordered_set>
#include <vector>

namespace {

inline bool is_ws(unsigned char c) {
    return c == ' ' || c == '\t' || c == '\n' || c == '\v' || c == '\f' ||
           c == '\r' || (c >= 0x1c && c <= 0x1f);
}

inline char ascii_lower(char c) {
    return (c >= 'A' && c <= 'Z') ? static_cast<char>(c + 32) : c;
}

}  // namespace

extern "C" {

// Returns 0 on success.  Outputs are malloc'd here and released with
// text_hash_free: slots/vals hold the concatenated per-doc sorted unique
// (slot, count) pairs, bounds is an (n_docs+1) prefix, status[i] is 1 when
// doc i contained non-ASCII bytes and was skipped (bounds stay flat there).
int text_hash_count(const char* buf, const int64_t* offsets, int64_t n_docs,
                    const char* stop_buf, const int64_t* stop_offsets,
                    int64_t n_stop, int lowercase, int lower_for_stop,
                    int64_t min_token_len, int64_t num_features, int binary,
                    int** out_slots, float** out_vals, int64_t** out_bounds,
                    unsigned char** out_status) {
    if (num_features <= 0) return 1;
    std::unordered_set<std::string> stop;
    stop.reserve(static_cast<size_t>(n_stop) * 2);
    for (int64_t i = 0; i < n_stop; ++i)
        stop.emplace(stop_buf + stop_offsets[i],
                     static_cast<size_t>(stop_offsets[i + 1] -
                                         stop_offsets[i]));

    std::vector<int> slots;
    std::vector<float> vals;
    std::vector<int64_t> bounds(1, 0);
    bounds.reserve(static_cast<size_t>(n_docs) + 1);
    unsigned char* status = static_cast<unsigned char*>(
        std::malloc(n_docs ? static_cast<size_t>(n_docs) : 1));
    if (!status) return 2;

    std::string token, lowered;
    std::vector<unsigned int> doc_slots;
    for (int64_t d = 0; d < n_docs; ++d) {
        const char* p = buf + offsets[d];
        const int64_t len = offsets[d + 1] - offsets[d];
        status[d] = 0;
        for (int64_t i = 0; i < len; ++i) {
            if (static_cast<unsigned char>(p[i]) >= 0x80) {
                status[d] = 1;  // non-ASCII: Python recomputes this row
                break;
            }
        }
        doc_slots.clear();
        if (!status[d]) {
            int64_t i = 0;
            while (i < len) {
                while (i < len && is_ws(static_cast<unsigned char>(p[i])))
                    ++i;
                int64_t start = i;
                while (i < len && !is_ws(static_cast<unsigned char>(p[i])))
                    ++i;
                const int64_t tlen = i - start;
                if (tlen == 0 || tlen < min_token_len) continue;
                token.assign(p + start, static_cast<size_t>(tlen));
                if (lowercase)
                    for (auto& c : token) c = ascii_lower(c);
                if (!stop.empty()) {
                    const std::string* probe = &token;
                    if (lower_for_stop && !lowercase) {
                        lowered = token;
                        for (auto& c : lowered) c = ascii_lower(c);
                        probe = &lowered;
                    }
                    if (stop.count(*probe)) continue;
                }
                const uLong h = crc32(
                    0L, reinterpret_cast<const Bytef*>(token.data()),
                    static_cast<uInt>(token.size()));
                doc_slots.push_back(static_cast<unsigned int>(
                    static_cast<uint64_t>(h) %
                    static_cast<uint64_t>(num_features)));
            }
            std::sort(doc_slots.begin(), doc_slots.end());
            for (size_t j = 0; j < doc_slots.size();) {
                size_t k = j;
                while (k < doc_slots.size() && doc_slots[k] == doc_slots[j])
                    ++k;
                slots.push_back(static_cast<int>(doc_slots[j]));
                vals.push_back(binary ? 1.0f
                                      : static_cast<float>(k - j));
                j = k;
            }
        }
        bounds.push_back(static_cast<int64_t>(slots.size()));
    }

    const size_t n_out = slots.size();
    int* s_out = static_cast<int*>(std::malloc(n_out ? n_out * 4 : 4));
    float* v_out = static_cast<float*>(std::malloc(n_out ? n_out * 4 : 4));
    int64_t* b_out = static_cast<int64_t*>(
        std::malloc(bounds.size() * sizeof(int64_t)));
    if (!s_out || !v_out || !b_out) {
        std::free(s_out); std::free(v_out); std::free(b_out);
        std::free(status);
        return 2;
    }
    if (n_out) {
        std::memcpy(s_out, slots.data(), n_out * 4);
        std::memcpy(v_out, vals.data(), n_out * 4);
    }
    std::memcpy(b_out, bounds.data(), bounds.size() * sizeof(int64_t));
    *out_slots = s_out;
    *out_vals = v_out;
    *out_bounds = b_out;
    *out_status = status;
    return 0;
}

void text_hash_free(int* slots, float* vals, int64_t* bounds,
                    unsigned char* status) {
    std::free(slots);
    std::free(vals);
    std::free(bounds);
    std::free(status);
}

}  // extern "C"
