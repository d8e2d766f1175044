// Native CLIP BPE tokenizer core.
//
// Host-side hot path for high-throughput corpus workloads (the COCO batch
// actions of the `daam` CLI and the demo server tokenize thousands of
// prompts; reference delegates to HF's Rust tokenizers — this is the
// framework's native equivalent, exposed to Python via ctypes with the pure
// Python implementation in daam_tpu/tokenization.py as fallback).
//
// Implements the same algorithm as ClipBpeTokenizer: whitespace-clean +
// lowercase, CLIP word regex, byte->unicode mapping, ranked BPE merges with
// </w> end-of-word markers.
//
// C ABI:
//   void*  daam_bpe_new(const char* vocab_json, const char* merges_txt);
//   void   daam_bpe_free(void*);
//   // tokenize to '\n'-joined token strings (caller buffer):
//   int    daam_bpe_tokenize(void*, const char* text, char* out, int cap);
//   // encode to ids with SOS/EOS + pad to max_len:
//   int    daam_bpe_encode(void*, const char* text, int* out, int max_len,
//                          int pad_id);
//   // vocab lookup for a single token string (-1 if absent):
//   int    daam_bpe_token_to_id(void*, const char* token);

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <fstream>
#include <sstream>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct PairHash {
    size_t operator()(const std::pair<std::string, std::string>& p) const {
        return std::hash<std::string>()(p.first) * 31 ^
               std::hash<std::string>()(p.second);
    }
};

struct Bpe {
    std::unordered_map<std::string, int> encoder;
    std::unordered_map<std::pair<std::string, std::string>, int, PairHash> ranks;
    std::unordered_map<uint8_t, std::string> byte_enc;
    std::unordered_map<std::string, std::vector<std::string>> cache;
    int sot_id = 49406, eot_id = 49407;
};

// GPT-2/CLIP reversible byte->printable-unicode map (mirrors
// tokenization.bytes_to_unicode).
void build_byte_encoder(Bpe& b) {
    std::vector<int> bs;
    for (int i = '!'; i <= '~'; ++i) bs.push_back(i);
    for (int i = 0xA1; i <= 0xAC; ++i) bs.push_back(i);
    for (int i = 0xAE; i <= 0xFF; ++i) bs.push_back(i);
    std::vector<int> cs(bs.begin(), bs.end());
    int n = 0;
    for (int i = 0; i < 256; ++i) {
        if (std::find(bs.begin(), bs.end(), i) == bs.end()) {
            bs.push_back(i);
            cs.push_back(256 + n++);
        }
    }
    for (size_t i = 0; i < bs.size(); ++i) {
        // encode unicode codepoint cs[i] as UTF-8
        int cp = cs[i];
        std::string s;
        if (cp < 0x80) {
            s += static_cast<char>(cp);
        } else if (cp < 0x800) {
            s += static_cast<char>(0xC0 | (cp >> 6));
            s += static_cast<char>(0x80 | (cp & 0x3F));
        } else {
            s += static_cast<char>(0xE0 | (cp >> 12));
            s += static_cast<char>(0x80 | ((cp >> 6) & 0x3F));
            s += static_cast<char>(0x80 | (cp & 0x3F));
        }
        b.byte_enc[static_cast<uint8_t>(bs[i])] = s;
    }
}

// Minimal JSON object parser for {"token": id, ...} vocab files.
bool parse_vocab_json(const std::string& path, Bpe& b) {
    std::ifstream f(path);
    if (!f) return false;
    std::stringstream ss;
    ss << f.rdbuf();
    const std::string s = ss.str();
    size_t i = 0;
    auto skip_ws = [&] { while (i < s.size() && isspace((unsigned char)s[i])) ++i; };
    skip_ws();
    if (i >= s.size() || s[i] != '{') return false;
    ++i;
    while (i < s.size()) {
        skip_ws();
        if (s[i] == '}') break;
        if (s[i] != '"') return false;
        ++i;
        std::string key;
        while (i < s.size() && s[i] != '"') {
            if (s[i] == '\\' && i + 1 < s.size()) {
                ++i;
                char c = s[i];
                if (c == 'u' && i + 4 < s.size()) {
                    int cp = std::stoi(s.substr(i + 1, 4), nullptr, 16);
                    if (cp < 0x80) key += static_cast<char>(cp);
                    else if (cp < 0x800) {
                        key += static_cast<char>(0xC0 | (cp >> 6));
                        key += static_cast<char>(0x80 | (cp & 0x3F));
                    } else {
                        key += static_cast<char>(0xE0 | (cp >> 12));
                        key += static_cast<char>(0x80 | ((cp >> 6) & 0x3F));
                        key += static_cast<char>(0x80 | (cp & 0x3F));
                    }
                    i += 4;
                } else if (c == 'n') key += '\n';
                else if (c == 't') key += '\t';
                else key += c;
            } else {
                key += s[i];
            }
            ++i;
        }
        ++i;  // closing quote
        skip_ws();
        if (s[i] != ':') return false;
        ++i;
        skip_ws();
        size_t j = i;
        while (j < s.size() && (isdigit((unsigned char)s[j]) || s[j] == '-')) ++j;
        b.encoder[key] = std::stoi(s.substr(i, j - i));
        i = j;
        skip_ws();
        if (i < s.size() && s[i] == ',') ++i;
    }
    return true;
}

bool parse_merges(const std::string& path, Bpe& b) {
    std::ifstream f(path);
    if (!f) return false;
    std::string line;
    int rank = 0;
    while (std::getline(f, line)) {
        if (line.empty() || line.rfind("#version", 0) == 0) continue;
        size_t sp = line.find(' ');
        if (sp == std::string::npos) continue;
        b.ranks[{line.substr(0, sp), line.substr(sp + 1)}] = rank++;
    }
    return true;
}

// ---- tokenization ---------------------------------------------------------

// Codepoint classification tables generated from the Python WORD_PATTERN
// regex semantics (scripts/gen_unicode_ranges.py) so the two tokenizers
// cannot drift: letter = [^\W\d_], digit = \d.
#include "unicode_ranges.inc"

bool in_ranges(uint32_t cp, const uint32_t ranges[][2], size_t n) {
    size_t lo = 0, hi = n;
    while (lo < hi) {
        size_t mid = (lo + hi) / 2;
        if (cp < ranges[mid][0]) hi = mid;
        else if (cp > ranges[mid][1]) lo = mid + 1;
        else return true;
    }
    return false;
}

bool cp_is_letter(uint32_t cp) {
    return in_ranges(cp, kLetterRanges, kLetterRanges_len);
}
bool cp_is_digit(uint32_t cp) {
    return in_ranges(cp, kDigitRanges, kDigitRanges_len);
}

// Decode one UTF-8 codepoint at text[i]; sets len (1 on malformed bytes,
// which then classify as punctuation like Python's surrogate-free handling).
uint32_t decode_utf8(const std::string& s, size_t i, size_t& len) {
    unsigned char c = s[i];
    if (c < 0x80) { len = 1; return c; }
    uint32_t cp;
    size_t extra;
    if ((c & 0xE0) == 0xC0) { cp = c & 0x1F; extra = 1; }
    else if ((c & 0xF0) == 0xE0) { cp = c & 0x0F; extra = 2; }
    else if ((c & 0xF8) == 0xF0) { cp = c & 0x07; extra = 3; }
    else { len = 1; return 0xFFFD; }
    if (i + extra >= s.size()) { len = 1; return 0xFFFD; }
    for (size_t k = 1; k <= extra; ++k) {
        unsigned char cc = s[i + k];
        if ((cc & 0xC0) != 0x80) { len = 1; return 0xFFFD; }
        cp = (cp << 6) | (cc & 0x3F);
    }
    len = extra + 1;
    return cp;
}

// CLIP word regex, hand-rolled over codepoints: special literals |
// contractions | letter runs | single digit | punctuation runs (whitespace
// splits).  Input arrives whitespace-cleaned + lowercased from the binding
// (unicode-correct lowering lives in Python).
std::vector<std::string> split_words(const std::string& text) {
    std::vector<std::string> out;
    size_t i = 0;
    const size_t n = text.size();
    static const char* specials[] = {"<|startoftext|>", "<|endoftext|>"};
    static const char* contractions[] = {"'s", "'t", "'re", "'ve", "'m",
                                         "'ll", "'d"};
    while (i < n) {
        unsigned char c = text[i];
        if (isspace(c)) { ++i; continue; }
        if (c == '<') {
            bool matched = false;
            for (const char* sp : specials) {
                size_t len = strlen(sp);
                if (text.compare(i, len, sp) == 0) {
                    out.emplace_back(sp);
                    i += len;
                    matched = true;
                    break;
                }
            }
            if (matched) continue;
        }
        if (c == '\'') {
            bool matched = false;
            for (const char* con : contractions) {
                size_t len = strlen(con);
                if (text.compare(i, len, con) == 0) {
                    out.emplace_back(text.substr(i, len));
                    i += len;
                    matched = true;
                    break;
                }
            }
            if (matched) continue;
        }
        size_t len;
        uint32_t cp = decode_utf8(text, i, len);
        if (cp_is_letter(cp)) {
            size_t j = i;
            while (j < n) {
                size_t l2;
                uint32_t c2 = decode_utf8(text, j, l2);
                if (!cp_is_letter(c2)) break;
                j += l2;
            }
            out.emplace_back(text.substr(i, j - i));
            i = j;
        } else if (cp_is_digit(cp)) {
            out.emplace_back(text.substr(i, len));   // \d matches ONE digit
            i += len;
        } else {
            size_t j = i;
            while (j < n && !isspace((unsigned char)text[j])) {
                size_t l2;
                uint32_t c2 = decode_utf8(text, j, l2);
                if (cp_is_letter(c2) || cp_is_digit(c2)) break;
                j += l2;
            }
            out.emplace_back(text.substr(i, j - i));
            i = j;
        }
    }
    return out;
}

std::vector<std::string> bpe_word(Bpe& b, const std::string& chunk) {
    auto it = b.cache.find(chunk);
    if (it != b.cache.end()) return it->second;

    // byte-encode then split into single-char (unicode) symbols
    std::string enc;
    for (unsigned char c : chunk) enc += b.byte_enc[c];
    std::vector<std::string> word;
    for (size_t i = 0; i < enc.size();) {
        unsigned char c = enc[i];
        size_t len = (c < 0x80) ? 1 : (c < 0xE0) ? 2 : (c < 0xF0) ? 3 : 4;
        word.emplace_back(enc.substr(i, len));
        i += len;
    }
    if (word.empty()) return {};
    word.back() += "</w>";

    while (word.size() > 1) {
        int best = INT32_MAX;
        size_t best_i = 0;
        for (size_t i = 0; i + 1 < word.size(); ++i) {
            auto r = b.ranks.find({word[i], word[i + 1]});
            if (r != b.ranks.end() && r->second < best) {
                best = r->second;
                best_i = i;
            }
        }
        if (best == INT32_MAX) break;
        // merge ALL occurrences of this pair, left to right
        const std::string a = word[best_i], bb = word[best_i + 1];
        std::vector<std::string> merged;
        for (size_t i = 0; i < word.size();) {
            if (i + 1 < word.size() && word[i] == a && word[i + 1] == bb) {
                merged.push_back(a + bb);
                i += 2;
            } else {
                merged.push_back(word[i]);
                ++i;
            }
        }
        word.swap(merged);
    }
    b.cache[chunk] = word;
    return word;
}

std::vector<std::string> tokenize(Bpe& b, std::string text) {
    // whitespace-clean + lowercase
    std::string clean;
    bool ws = true;
    for (char& c : text) {
        if (isspace((unsigned char)c)) {
            if (!ws && !clean.empty()) clean += ' ';
            ws = true;
        } else {
            clean += static_cast<char>(tolower((unsigned char)c));
            ws = false;
        }
    }
    while (!clean.empty() && clean.back() == ' ') clean.pop_back();

    std::vector<std::string> tokens;
    for (const auto& w : split_words(clean)) {
        if (w == "<|startoftext|>" || w == "<|endoftext|>") {
            tokens.push_back(w);   // special literals pass through unsplit
            continue;
        }
        auto pieces = bpe_word(b, w);
        tokens.insert(tokens.end(), pieces.begin(), pieces.end());
    }
    return tokens;
}

}  // namespace

extern "C" {

void* daam_bpe_new(const char* vocab_json, const char* merges_txt) {
    auto* b = new Bpe();
    build_byte_encoder(*b);
    if (!parse_vocab_json(vocab_json, *b) || !parse_merges(merges_txt, *b)) {
        delete b;
        return nullptr;
    }
    auto sot = b->encoder.find("<|startoftext|>");
    auto eot = b->encoder.find("<|endoftext|>");
    if (sot != b->encoder.end()) b->sot_id = sot->second;
    if (eot != b->encoder.end()) b->eot_id = eot->second;
    return b;
}

void daam_bpe_free(void* h) { delete static_cast<Bpe*>(h); }

int daam_bpe_sot_id(void* h) { return static_cast<Bpe*>(h)->sot_id; }
int daam_bpe_eot_id(void* h) { return static_cast<Bpe*>(h)->eot_id; }
int daam_bpe_vocab_size(void* h) {
    int mx = 0;
    for (const auto& kv : static_cast<Bpe*>(h)->encoder)
        mx = std::max(mx, kv.second);
    return mx + 1;
}

int daam_bpe_token_to_id(void* h, const char* token) {
    auto* b = static_cast<Bpe*>(h);
    auto it = b->encoder.find(token);
    return it != b->encoder.end() ? it->second : -1;
}

int daam_bpe_tokenize(void* h, const char* text, char* out, int cap) {
    auto* b = static_cast<Bpe*>(h);
    auto toks = tokenize(*b, text);
    int pos = 0;
    for (size_t i = 0; i < toks.size(); ++i) {
        int need = static_cast<int>(toks[i].size()) + 1;
        if (pos + need >= cap) return -1;
        memcpy(out + pos, toks[i].c_str(), toks[i].size());
        pos += static_cast<int>(toks[i].size());
        out[pos++] = '\n';
    }
    out[pos] = '\0';
    return static_cast<int>(toks.size());
}

int daam_bpe_encode(void* h, const char* text, int* out, int max_len,
                    int pad_id) {
    auto* b = static_cast<Bpe*>(h);
    auto toks = tokenize(*b, text);
    int n = 0;
    out[n++] = b->sot_id;
    for (const auto& t : toks) {
        if (n >= max_len - 1) break;
        auto it = b->encoder.find(t);
        out[n++] = (it != b->encoder.end()) ? it->second : b->eot_id;
    }
    out[n++] = b->eot_id;
    int real = n;
    while (n < max_len) out[n++] = (pad_id < 0 ? b->eot_id : pad_id);
    return real;
}

}  // extern "C"
