// Native WordPiece tokenizer engine: the port's copy of the JAX package's
// native/wordpiece.cpp, the same source and C ABI.
//
// Host tokenization rate-limits the embed+index pipeline when done per-doc
// in Python, so the whole batch is tokenized in one C call: BERT basic
// tokenization (lowercase, whitespace/punctuation/CJK split) followed by
// greedy longest-match-first WordPiece against a vocab.txt-style vocab.
// The ids equal the pure-Python engine's
// (pathway_tpu_torch/models/tokenizer.py, tests/test_torch_wordpiece.py).
//
// Simplifications vs HF BertTokenizer: no accent stripping (NFD), no
// never-split/special-token passthrough inside text.
//
// C ABI consumed via ctypes from pathway_tpu_torch/native/__init__.py.
// Build: g++ -std=c++17 -O2 -shared -fPIC, driven by
// pathway_tpu_torch/native/build.py into pathway_tpu_torch/_build/.

#include <cctype>
#include <cstdint>
#include <cstring>
#include <string>
#include <string_view>
#include <unordered_map>
#include <vector>

namespace {

struct Vocab {
    std::unordered_map<std::string, int32_t> full;  // word-initial pieces
    std::unordered_map<std::string, int32_t> cont;  // "##" continuations
    bool lower = true;
    int32_t max_word_chars = 100;
};

inline bool is_ascii_punct(unsigned char c) {
    return (c >= 33 && c <= 47) || (c >= 58 && c <= 64) ||
           (c >= 91 && c <= 96) || (c >= 123 && c <= 126);
}

// HF BasicTokenizer classes: whitespace = " \t\n\r" + category Zs;
// other control chars are DROPPED entirely (HF _clean_text)
inline bool is_space(unsigned char c) {
    return c == ' ' || c == '\t' || c == '\n' || c == '\r';
}

inline bool is_ascii_control(unsigned char c) {
    return (c < 0x20 && c != '\t' && c != '\n' && c != '\r') || c == 0x7F;
}

// Unicode Zs category (minus ASCII space) + Zl/Zp: HF's
// whitespace_tokenize uses str.split(), which splits on the line and
// paragraph separators too
inline bool is_unicode_space(uint32_t cp) {
    return cp == 0xA0 || cp == 0x1680 || (cp >= 0x2000 && cp <= 0x200A) ||
           cp == 0x202F || cp == 0x205F || cp == 0x3000 ||
           cp == 0x2028 || cp == 0x2029;
}

// practical C* set: C1 controls (incl. NEL 0x85), soft hyphen, Mongolian
// vowel separator, Arabic/Syriac format marks, zero-width and
// directional/isolate format chars, word joiner, BOM
inline bool is_unicode_control(uint32_t cp) {
    return (cp >= 0x80 && cp <= 0x9F) || cp == 0xAD ||
           (cp >= 0x0600 && cp <= 0x0605) || cp == 0x061C ||
           cp == 0x06DD || cp == 0x070F || cp == 0x08E2 || cp == 0x180E ||
           (cp >= 0x200B && cp <= 0x200F) ||
           (cp >= 0x202A && cp <= 0x202E) ||
           (cp >= 0x2060 && cp <= 0x2064) ||
           (cp >= 0x2066 && cp <= 0x206F) || cp == 0xFEFF;
}

// decode one UTF-8 codepoint; returns its byte length (0 on malformed)
inline int utf8_len(const unsigned char* p, const unsigned char* end) {
    if (p >= end) return 0;
    if (*p < 0x80) return 1;
    int n = (*p >= 0xF0) ? 4 : (*p >= 0xE0) ? 3 : (*p >= 0xC0) ? 2 : 0;
    if (n == 0 || p + n > end) return 0;
    for (int i = 1; i < n; ++i)
        if ((p[i] & 0xC0) != 0x80) return 0;
    return n;
}

inline uint32_t utf8_cp(const unsigned char* p, int n) {
    switch (n) {
        case 1: return p[0];
        case 2: return ((p[0] & 0x1Fu) << 6) | (p[1] & 0x3Fu);
        case 3: return ((p[0] & 0x0Fu) << 12) | ((p[1] & 0x3Fu) << 6) |
                       (p[2] & 0x3Fu);
        default: return ((p[0] & 0x07u) << 18) | ((p[1] & 0x3Fu) << 12) |
                        ((p[2] & 0x3Fu) << 6) | (p[3] & 0x3Fu);
    }
}

// BERT treats every CJK codepoint as its own word
inline bool is_cjk(uint32_t cp) {
    return (cp >= 0x4E00 && cp <= 0x9FFF) || (cp >= 0x3400 && cp <= 0x4DBF) ||
           (cp >= 0x20000 && cp <= 0x2A6DF) || (cp >= 0xF900 && cp <= 0xFADF);
}

// split text into basic tokens (words / single punctuation / single CJK);
// each token is a (start, len) span over `lowered`
void basic_tokenize(const std::string& lowered,
                    std::vector<std::pair<size_t, size_t>>& out) {
    const auto* base = reinterpret_cast<const unsigned char*>(lowered.data());
    const auto* end = base + lowered.size();
    size_t i = 0, n = lowered.size();
    size_t word_start = std::string::npos;
    auto flush = [&](size_t upto) {
        if (word_start != std::string::npos) {
            out.emplace_back(word_start, upto - word_start);
            word_start = std::string::npos;
        }
    };
    while (i < n) {
        unsigned char c = base[i];
        if (c < 0x80) {
            if (is_space(c)) {
                flush(i);
                ++i;
            } else if (is_ascii_punct(c)) {
                flush(i);
                out.emplace_back(i, 1);
                ++i;
            } else {
                if (word_start == std::string::npos) word_start = i;
                ++i;
            }
            continue;
        }
        int len = utf8_len(base + i, end);
        if (len == 0) {  // malformed byte: drop it
            flush(i);
            ++i;
            continue;
        }
        uint32_t cp = utf8_cp(base + i, len);
        if (is_cjk(cp)) {
            flush(i);
            out.emplace_back(i, static_cast<size_t>(len));
        } else if (is_unicode_space(cp)) {
            flush(i);
        } else {
            if (word_start == std::string::npos) word_start = i;
        }
        i += static_cast<size_t>(len);
    }
    flush(n);
}

// greedy longest-match-first WordPiece over one basic token
void wordpiece(const Vocab& v, std::string_view word, int32_t unk_id,
               std::vector<int32_t>& out) {
    if (word.size() > static_cast<size_t>(v.max_word_chars)) {
        out.push_back(unk_id);
        return;
    }
    size_t start = 0;
    std::vector<int32_t> pieces;
    std::string buf;
    auto on_boundary = [&](size_t pos) {
        return pos >= word.size() ||
               (static_cast<unsigned char>(word[pos]) & 0xC0) != 0x80;
    };
    while (start < word.size()) {
        size_t end = word.size();
        int32_t found = -1;
        const auto& table = (start == 0) ? v.full : v.cont;
        while (end > start) {
            // never split inside a multi-byte UTF-8 char
            if (on_boundary(end)) {
                buf.assign(word.substr(start, end - start));
                auto it = table.find(buf);
                if (it != table.end()) {
                    found = it->second;
                    break;
                }
            }
            --end;
        }
        if (found < 0) {
            out.push_back(unk_id);
            return;  // whole word becomes [UNK], matching HF
        }
        pieces.push_back(found);
        start = end;
    }
    out.insert(out.end(), pieces.begin(), pieces.end());
}

}  // namespace

extern "C" {

// vocab_blob: '\n'-separated piece strings; id = line index (vocab.txt)
void* wp_new(const char* vocab_blob, int64_t blob_len, int32_t do_lower) {
    auto* v = new Vocab();
    v->lower = do_lower != 0;
    int32_t id = 0;
    const char* p = vocab_blob;
    const char* end = vocab_blob + blob_len;
    while (p < end) {
        const char* nl = static_cast<const char*>(
            memchr(p, '\n', static_cast<size_t>(end - p)));
        size_t len = nl ? static_cast<size_t>(nl - p)
                        : static_cast<size_t>(end - p);
        if (len > 0 && p[len - 1] == '\r') --len;
        std::string tok(p, len);
        if (tok.size() >= 2 && tok[0] == '#' && tok[1] == '#') {
            v->cont.emplace(tok.substr(2), id);
        } else {
            v->full.emplace(std::move(tok), id);
        }
        ++id;
        p = nl ? nl + 1 : end;
    }
    return v;
}

void wp_free(void* h) { delete static_cast<Vocab*>(h); }

// Tokenize n_texts documents in one call.
//   texts: concatenated UTF-8 bytes; offsets[i]..offsets[i+1] = doc i
//   out_ids: n_texts * max_len int32, pre-filled by callee with pad_id
//   out_lens: n_texts int32 (emitted length incl. CLS/SEP)
// Layout per doc: [CLS] pieces... [SEP], truncated to max_len.
void wp_encode_batch(void* h, const char* texts, const int64_t* offsets,
                     int32_t n_texts, int32_t max_len, int32_t cls_id,
                     int32_t sep_id, int32_t unk_id, int32_t pad_id,
                     int32_t* out_ids, int32_t* out_lens) {
    const auto* v = static_cast<const Vocab*>(h);
    std::string lowered;
    std::vector<std::pair<size_t, size_t>> words;
    std::vector<int32_t> ids;
    for (int32_t t = 0; t < n_texts; ++t) {
        const char* s = texts + offsets[t];
        size_t n = static_cast<size_t>(offsets[t + 1] - offsets[t]);
        // cleaning pass (HF _clean_text): drop control/format chars so a
        // word interrupted by one CONCATENATES; lowercase ASCII
        lowered.clear();
        lowered.reserve(n);
        const auto* sb = reinterpret_cast<const unsigned char*>(s);
        const auto* se = sb + n;
        size_t j = 0;
        while (j < n) {
            unsigned char c = sb[j];
            if (c < 0x80) {
                if (!is_ascii_control(c)) {
                    lowered.push_back(
                        v->lower ? static_cast<char>(tolower(c))
                                 : static_cast<char>(c));
                }
                ++j;
                continue;
            }
            int len = utf8_len(sb + j, se);
            if (len == 0) {
                ++j;  // malformed byte: drop
                continue;
            }
            if (!is_unicode_control(utf8_cp(sb + j, len))) {
                lowered.append(s + j, static_cast<size_t>(len));
            }
            j += static_cast<size_t>(len);
        }
        words.clear();
        basic_tokenize(lowered, words);
        ids.clear();
        ids.push_back(cls_id);
        for (const auto& [off, len] : words) {
            if (static_cast<int32_t>(ids.size()) >= max_len - 1) break;
            wordpiece(*v, std::string_view(lowered).substr(off, len), unk_id,
                      ids);
        }
        if (static_cast<int32_t>(ids.size()) > max_len - 1)
            ids.resize(static_cast<size_t>(max_len - 1));
        ids.push_back(sep_id);
        int32_t* row = out_ids + static_cast<int64_t>(t) * max_len;
        std::copy(ids.begin(), ids.end(), row);
        for (int32_t j = static_cast<int32_t>(ids.size()); j < max_len; ++j)
            row[j] = pad_id;
        out_lens[t] = static_cast<int32_t>(ids.size());
    }
}

}  // extern "C"
