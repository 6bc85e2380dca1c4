// bert_pytorch_tpu native tokenizer core.
//
// C++ replacement for the HuggingFace Rust `tokenizers` dependency the
// reference drives for its entire offline pipeline and runtime data path
// (reference src/tokenization.py:42-57, utils/build_vocab.py:39-58,
// utils/encode_data.py:280-293; SURVEY.md §2.3). The behavioral
// specification is the pure-Python BasicTokenizer/WordpieceTokenizer
// (src/tokenization.py:60-229 ≙ bert_pytorch_tpu/data/tokenization.py).
//
// Pipeline: UTF-8 decode -> clean (drop control/NUL/replacement chars,
// canonicalize whitespace) -> CJK isolation -> never_split passthrough for
// special tokens -> optional lowercase + accent strip (full-Unicode
// lower()+NFD+drop-Mn fold tables generated from Python unicodedata by
// gen_unicode_tables.py, plus algorithmic Hangul decomposition and the
// Final_Sigma rule) -> punctuation split -> greedy longest-match WordPiece
// against a prefix-keyed hash vocab.
//
// Exposed as a C ABI for ctypes (see tools/tokenizer_cpp.py). A WordPiece
// vocab trainer (pair-merge algorithm over word counts) lives here too,
// replacing BertWordPieceTokenizer.train.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <fstream>
#include <map>
#include <sstream>
#include <string>
#include <unordered_map>
#include <unordered_set>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// UTF-8
// ---------------------------------------------------------------------------

// Decode one UTF-8 codepoint starting at s[i]; advances i. Invalid bytes
// decode as U+FFFD and advance by one.
uint32_t decode_utf8(const std::string& s, size_t& i) {
  unsigned char c = s[i];
  if (c < 0x80) { i += 1; return c; }
  if ((c >> 5) == 0x6 && i + 1 < s.size()) {
    uint32_t cp = ((c & 0x1F) << 6) | (s[i + 1] & 0x3F);
    i += 2; return cp;
  }
  if ((c >> 4) == 0xE && i + 2 < s.size()) {
    uint32_t cp = ((c & 0x0F) << 12) | ((s[i + 1] & 0x3F) << 6) |
                  (s[i + 2] & 0x3F);
    i += 3; return cp;
  }
  if ((c >> 3) == 0x1E && i + 3 < s.size()) {
    uint32_t cp = ((c & 0x07) << 18) | ((s[i + 1] & 0x3F) << 12) |
                  ((s[i + 2] & 0x3F) << 6) | (s[i + 3] & 0x3F);
    i += 4; return cp;
  }
  i += 1;
  return 0xFFFD;
}

void encode_utf8(uint32_t cp, std::string& out) {
  if (cp < 0x80) {
    out.push_back(static_cast<char>(cp));
  } else if (cp < 0x800) {
    out.push_back(static_cast<char>(0xC0 | (cp >> 6)));
    out.push_back(static_cast<char>(0x80 | (cp & 0x3F)));
  } else if (cp < 0x10000) {
    out.push_back(static_cast<char>(0xE0 | (cp >> 12)));
    out.push_back(static_cast<char>(0x80 | ((cp >> 6) & 0x3F)));
    out.push_back(static_cast<char>(0x80 | (cp & 0x3F)));
  } else {
    out.push_back(static_cast<char>(0xF0 | (cp >> 18)));
    out.push_back(static_cast<char>(0x80 | ((cp >> 12) & 0x3F)));
    out.push_back(static_cast<char>(0x80 | ((cp >> 6) & 0x3F)));
    out.push_back(static_cast<char>(0x80 | (cp & 0x3F)));
  }
}

// ---------------------------------------------------------------------------
// Character classes — range tables generated from Python unicodedata by
// gen_unicode_tables.py (the behavioral spec is the pure-Python
// BasicTokenizer's unicodedata.category calls, reference
// src/tokenization.py:120-173). Full Unicode coverage, no ICU dependency.
// ---------------------------------------------------------------------------

struct CpRange { uint32_t lo, hi; };
#include "unicode_tables.inc"

bool in_ranges(uint32_t cp, const CpRange* table, size_t count) {
  size_t lo = 0, hi = count;
  while (lo < hi) {
    size_t mid = (lo + hi) / 2;
    if (cp < table[mid].lo) hi = mid;
    else if (cp > table[mid].hi) lo = mid + 1;
    else return true;
  }
  return false;
}

bool is_whitespace(uint32_t cp) {
  if (cp == ' ' || cp == '\t' || cp == '\n' || cp == '\r') return true;
  if (cp < 0x80) return false;
  return in_ranges(cp, kWhitespace, kWhitespaceCount);
}

bool is_control(uint32_t cp) {
  if (cp == '\t' || cp == '\n' || cp == '\r') return false;
  if (cp < 0x80) return cp < 0x20 || cp == 0x7F;
  return in_ranges(cp, kControl, kControlCount);
}

bool is_ascii_punct(uint32_t cp) {
  return (cp >= 33 && cp <= 47) || (cp >= 58 && cp <= 64) ||
         (cp >= 91 && cp <= 96) || (cp >= 123 && cp <= 126);
}

bool is_punct(uint32_t cp) {
  // ASCII non-alphanumerics count as punctuation even where Unicode
  // disagrees ('$', '`'), matching the spec's explicit override.
  if (cp < 0x80) return is_ascii_punct(cp);
  return in_ranges(cp, kPunct, kPunctCount);
}

bool is_cased_cp(uint32_t cp) {
  return in_ranges(cp, kCased, kCasedCount);
}

bool is_case_ignorable_cp(uint32_t cp) {
  return in_ranges(cp, kCaseIgnorable, kCaseIgnorableCount);
}

// Final_Sigma per CPython str.lower() (whose Cased/Case_Ignorable sets the
// generated tables reproduce exactly — probed, not approximated): the
// capital sigma at cps[j] takes the final form iff a cased character
// precedes it (skipping case-ignorables) and no cased character follows it
// (skipping case-ignorables). The scan is bounded to the word because the
// spec lower()s one whitespace token at a time.
bool sigma_is_final(const std::vector<uint32_t>& cps, size_t j) {
  bool preceded = false;
  for (size_t k = j; k > 0;) {
    uint32_t c = cps[--k];
    if (is_case_ignorable_cp(c)) continue;
    preceded = is_cased_cp(c);
    break;
  }
  if (!preceded) return false;
  for (size_t k = j + 1; k < cps.size(); k++) {
    uint32_t c = cps[k];
    if (is_case_ignorable_cp(c)) continue;
    return !is_cased_cp(c);
  }
  return true;
}

bool is_cjk(uint32_t cp) {
  return (cp >= 0x4E00 && cp <= 0x9FFF) || (cp >= 0x3400 && cp <= 0x4DBF) ||
         (cp >= 0x20000 && cp <= 0x2A6DF) || (cp >= 0x2A700 && cp <= 0x2B73F) ||
         (cp >= 0x2B740 && cp <= 0x2B81F) || (cp >= 0x2B820 && cp <= 0x2CEAF) ||
         (cp >= 0xF900 && cp <= 0xFAFF) || (cp >= 0x2F800 && cp <= 0x2FA1F);
}

// Per-codepoint fold: lower() + NFD + drop category-Mn, the spec's
// do_lower_case normalization (reference tokenization.py:94-102). Appends
// the 0..3 output codepoints to `out`. ``sigma_final`` is the Final_Sigma
// context for U+03A3 (sigma_is_final, computed by the caller which holds
// the whole word).
void fold_cp(uint32_t cp, bool sigma_final, std::vector<uint32_t>& out) {
  if (cp < 0x80) {
    out.push_back(cp >= 'A' && cp <= 'Z' ? cp + 32 : cp);
    return;
  }
  if (cp == 0x03A3) {  // GREEK CAPITAL SIGMA: context-sensitive lower()
    out.push_back(sigma_final ? 0x03C2 : 0x03C3);
    return;
  }
  if (cp >= 0xAC00 && cp <= 0xD7A3) {  // Hangul syllable: algorithmic NFD
    uint32_t s = cp - 0xAC00;
    out.push_back(0x1100 + s / 588);
    out.push_back(0x1161 + (s % 588) / 28);
    if (s % 28) out.push_back(0x11A7 + s % 28);
    return;
  }
  size_t lo = 0, hi = kFoldCount;
  while (lo < hi) {
    size_t mid = (lo + hi) / 2;
    if (kFoldKeys[mid] < cp) lo = mid + 1; else hi = mid;
  }
  if (lo < kFoldCount && kFoldKeys[lo] == cp) {
    // An all-zero entry means "drop" (standalone combining marks).
    for (int j = 0; j < 3 && kFoldVals[lo][j]; j++)
      out.push_back(kFoldVals[lo][j]);
    return;
  }
  out.push_back(cp);
}

// ---------------------------------------------------------------------------
// WordPiece tokenizer
// ---------------------------------------------------------------------------

struct Tokenizer {
  std::unordered_map<std::string, int> vocab;
  std::vector<std::string> id_to_token;
  bool lowercase = true;
  int unk_id = 0;
  // Spec: reference tokenization.py:181 (chars = CODEPOINTS, not bytes).
  size_t max_chars_per_word = 100;
  size_t max_token_len = 0;  // longest vocab entry (bytes), bounds matching
  // Special tokens pass through basic_tokenize verbatim — no lowercase,
  // no accent strip, no punctuation split (reference tokenization.py:64-75).
  std::unordered_set<std::string> never_split{
      "[UNK]", "[SEP]", "[PAD]", "[CLS]", "[MASK]"};

  std::vector<int> last_ids;           // result buffers for the C API
  std::string last_tokens_joined;      // '\n'-joined token strings
};

// Normalize + split into word/punct chunks (BasicTokenizer semantics:
// clean -> CJK isolation -> whitespace split -> per-token never_split
// passthrough OR lower+NFD-strip -> punctuation split).
std::vector<std::string> basic_tokenize(const Tokenizer& t,
                                        const std::string& text) {
  // Pass 1: clean + CJK isolation + whitespace split. No case folding yet:
  // never_split matching and the Final_Sigma rule need the whole raw token.
  std::vector<std::string> words;
  std::string current;
  auto flush_word = [&]() {
    if (!current.empty()) { words.push_back(current); current.clear(); }
  };
  size_t i = 0;
  while (i < text.size()) {
    uint32_t cp = decode_utf8(text, i);
    if (cp == 0 || cp == 0xFFFD || is_control(cp)) continue;
    if (is_whitespace(cp)) { flush_word(); continue; }
    if (is_cjk(cp)) {  // CJK chars become standalone tokens
      flush_word();
      std::string c; encode_utf8(cp, c); words.push_back(c);
      continue;
    }
    encode_utf8(cp, current);
  }
  flush_word();

  // Pass 2: per whitespace token, fold + punctuation split.
  std::vector<std::string> out;
  std::vector<uint32_t> cps, folded;
  for (const auto& word : words) {
    if (t.never_split.count(word)) { out.push_back(word); continue; }
    cps.clear();
    for (size_t j = 0; j < word.size();) cps.push_back(decode_utf8(word, j));
    folded.clear();
    if (t.lowercase) {
      for (size_t j = 0; j < cps.size(); j++)
        fold_cp(cps[j],
                cps[j] == 0x03A3 && sigma_is_final(cps, j), folded);
    } else {
      folded = cps;
    }
    std::string chunk;
    auto flush_chunk = [&]() {
      if (!chunk.empty()) { out.push_back(chunk); chunk.clear(); }
    };
    for (uint32_t cp : folded) {
      if (is_punct(cp)) {
        flush_chunk();
        std::string c; encode_utf8(cp, c); out.push_back(c);
      } else {
        encode_utf8(cp, chunk);
      }
    }
    flush_chunk();
  }
  return out;
}

// Greedy longest-match WordPiece on one word (already normalized).
void wordpiece(const Tokenizer& t, const std::string& word,
               std::vector<int>& ids, std::vector<std::string>& tokens) {
  size_t n_chars = 0;
  for (size_t i = 0; i < word.size();) {
    decode_utf8(word, i);
    n_chars++;
  }
  if (n_chars > t.max_chars_per_word) {
    ids.push_back(t.unk_id);
    tokens.push_back(t.id_to_token[t.unk_id]);
    return;
  }
  std::vector<int> piece_ids;
  std::vector<std::string> piece_tokens;
  size_t start = 0;
  while (start < word.size()) {
    size_t end = word.size();
    int found = -1;
    std::string found_tok;
    while (start < end) {
      std::string sub = word.substr(start, end - start);
      if (start > 0) sub = "##" + sub;
      if (sub.size() <= t.max_token_len) {
        auto it = t.vocab.find(sub);
        if (it != t.vocab.end()) { found = it->second; found_tok = sub; break; }
      }
      // step back one UTF-8 codepoint
      do { end--; } while (end > start && (word[end] & 0xC0) == 0x80);
    }
    if (found < 0) {
      ids.push_back(t.unk_id);
      tokens.push_back(t.id_to_token[t.unk_id]);
      return;
    }
    piece_ids.push_back(found);
    piece_tokens.push_back(found_tok);
    start = end;
  }
  ids.insert(ids.end(), piece_ids.begin(), piece_ids.end());
  tokens.insert(tokens.end(), piece_tokens.begin(), piece_tokens.end());
}

// ---------------------------------------------------------------------------
// WordPiece vocab trainer (pair-merge over word counts)
// ---------------------------------------------------------------------------

struct TrainerState {
  // Global word counts across all input files (one entry per distinct word
  // — counting per-file and appending would duplicate frequent words N×
  // and inflate every merge iteration's scan by the same factor).
  std::unordered_map<std::string, long> counts;
  // Built from `counts` once at train time: each word as a sequence of
  // symbols; continuation symbols carry "##".
  std::vector<std::pair<std::vector<std::string>, long>> words;
};

void trainer_count_file(TrainerState& st, Tokenizer& norm,
                        const std::string& path) {
  std::ifstream in(path);
  std::string line;
  while (std::getline(in, line)) {
    for (const auto& w : basic_tokenize(norm, line)) st.counts[w] += 1;
  }
}

void trainer_build_words(TrainerState& st) {
  st.words.clear();
  st.words.reserve(st.counts.size());
  for (auto& kv : st.counts) {
    std::vector<std::string> symbols;
    size_t i = 0;
    bool first = true;
    while (i < kv.first.size()) {
      size_t j = i;
      decode_utf8(kv.first, j);
      std::string sym = kv.first.substr(i, j - i);
      symbols.push_back(first ? sym : "##" + sym);
      first = false;
      i = j;
    }
    st.words.emplace_back(std::move(symbols), kv.second);
  }
}

std::vector<std::string> trainer_run(TrainerState& st, size_t vocab_size,
                                     const std::vector<std::string>& specials,
                                     long min_frequency) {
  trainer_build_words(st);
  // Alphabet first.
  std::map<std::string, long> alphabet;
  for (auto& [symbols, count] : st.words)
    for (auto& s : symbols) alphabet[s] += count;

  std::vector<std::string> vocab(specials);
  for (auto& kv : alphabet) vocab.push_back(kv.first);

  auto merged_symbol = [](const std::string& a, const std::string& b) {
    // "fo" + "##o" -> "foo"; "##f" + "##oo" -> "##foo"
    return a + (b.rfind("##", 0) == 0 ? b.substr(2) : b);
  };

  while (vocab.size() < vocab_size) {
    std::map<std::pair<std::string, std::string>, long> pair_counts;
    for (auto& [symbols, count] : st.words)
      for (size_t i = 0; i + 1 < symbols.size(); i++)
        pair_counts[{symbols[i], symbols[i + 1]}] += count;
    if (pair_counts.empty()) break;
    auto best = std::max_element(
        pair_counts.begin(), pair_counts.end(),
        [](const auto& a, const auto& b) { return a.second < b.second; });
    if (best->second < min_frequency) break;
    const auto [left, right] = best->first;
    std::string merged = merged_symbol(left, right);
    vocab.push_back(merged);
    for (auto& [symbols, count] : st.words) {
      std::vector<std::string> out;
      out.reserve(symbols.size());
      size_t i = 0;
      while (i < symbols.size()) {
        if (i + 1 < symbols.size() && symbols[i] == left &&
            symbols[i + 1] == right) {
          out.push_back(merged);
          i += 2;
        } else {
          out.push_back(symbols[i]);
          i += 1;
        }
      }
      symbols = std::move(out);
    }
  }
  return vocab;
}

// ---------------------------------------------------------------------------
// Byte-level BPE (GPT-2/RoBERTa; reference src/tokenization.py:51-57 drives
// HF ByteLevelBPETokenizer — this is the C++ equivalent of its encode path)
// ---------------------------------------------------------------------------

// Unicode letter/number classes for the GPT-2 pre-tokenizer regex
// (\p{L}/\p{N}). Covers ASCII, Latin-1/Extended, Greek, Cyrillic, CJK,
// kana, and Hangul — the scripts in BERT/RoBERTa's corpora; exotic scripts
// degrade to the punctuation branch, mirroring the fold-table stance above.
bool is_letter(uint32_t cp) {
  if ((cp >= 'a' && cp <= 'z') || (cp >= 'A' && cp <= 'Z')) return true;
  if (cp == 0x00AA || cp == 0x00B5 || cp == 0x00BA) return true;
  if (cp >= 0x00C0 && cp <= 0x02AF && cp != 0x00D7 && cp != 0x00F7) return true;
  if (cp >= 0x0386 && cp <= 0x03FF && cp != 0x0387) return true;  // Greek
  if (cp >= 0x0400 && cp <= 0x04FF) return true;                  // Cyrillic
  // Kana LETTERS only: the block also holds combining sound marks
  // (U+3099-U+309C), the interpunct U+30FB, and U+30A0 (punctuation),
  // which \p{L} excludes.
  if ((cp >= 0x3041 && cp <= 0x3096) || (cp >= 0x309D && cp <= 0x309F) ||
      (cp >= 0x30A1 && cp <= 0x30FA) || (cp >= 0x30FC && cp <= 0x30FF))
    return true;
  if (cp >= 0xAC00 && cp <= 0xD7A3) return true;                  // Hangul
  return is_cjk(cp);
}

bool is_number(uint32_t cp) {
  if (cp >= '0' && cp <= '9') return true;
  return cp == 0x00B2 || cp == 0x00B3 || cp == 0x00B9 ||
         (cp >= 0x00BC && cp <= 0x00BE) || (cp >= 0x0660 && cp <= 0x0669);
}

// \s of the GPT-2 regex (Unicode whitespace).
bool is_bpe_space(uint32_t cp) {
  return is_whitespace(cp) || cp == 0x0B || cp == 0x0C || cp == 0x85 ||
         cp == 0x2028 || cp == 0x2029;
}

uint32_t simple_lower(uint32_t cp) {
  // HF Lowercase normalizer (no accent strip). ASCII + Latin-1 + Greek +
  // Cyrillic. Latin Extended-A pairs upper/lower adjacently but the parity
  // FLIPS at U+0138 (and Ÿ lives at U+0178 with its lowercase back in
  // Latin-1), so the ranges are spelled out.
  if (cp >= 'A' && cp <= 'Z') return cp + 32;
  if (cp >= 0x00C0 && cp <= 0x00DE && cp != 0x00D7) return cp + 32;
  if (cp >= 0x0100 && cp <= 0x0137 && cp % 2 == 0) return cp + 1;
  if (cp >= 0x0139 && cp <= 0x0148 && cp % 2 == 1) return cp + 1;
  if (cp >= 0x014A && cp <= 0x0177 && cp % 2 == 0) return cp + 1;
  if (cp == 0x0178) return 0x00FF;
  if (cp >= 0x0179 && cp <= 0x017E && cp % 2 == 1) return cp + 1;
  if (cp == 0x0386) return 0x03AC;                       // accented Greek
  if (cp >= 0x0388 && cp <= 0x038A) return cp + 0x25;
  if (cp == 0x038C) return 0x03CC;
  if (cp == 0x038E || cp == 0x038F) return cp + 0x3F;
  if (cp == 0x03AA || cp == 0x03AB) return cp + 0x20;
  if (cp >= 0x0391 && cp <= 0x03A9 && cp != 0x03A2) return cp + 32;
  if (cp >= 0x0400 && cp <= 0x040F) return cp + 0x50;    // Ѐ-Џ -> ѐ-џ
  if (cp >= 0x0410 && cp <= 0x042F) return cp + 32;
  return cp;
}

// Lowercase a UTF-8 string via simple_lower (shared by bpe_encode and the
// trainer so training and encoding segment words identically).
std::string lower_utf8(const std::string& s) {
  std::string out;
  out.reserve(s.size());
  size_t i = 0;
  while (i < s.size()) encode_utf8(simple_lower(decode_utf8(s, i)), out);
  return out;
}

// Merge every adjacent (left, right) occurrence left-to-right — THE merge
// semantics; bpe_word and the trainer must agree on it exactly.
std::vector<std::string> apply_merge(const std::vector<std::string>& symbols,
                                     const std::string& left,
                                     const std::string& right) {
  std::vector<std::string> out;
  out.reserve(symbols.size());
  for (size_t i = 0; i < symbols.size();) {
    if (i + 1 < symbols.size() && symbols[i] == left &&
        symbols[i + 1] == right) {
      out.push_back(left + right);
      i += 2;
    } else {
      out.push_back(symbols[i]);
      i += 1;
    }
  }
  return out;
}

struct BpeTokenizer {
  std::unordered_map<std::string, int> vocab;  // byte-mapped token -> id
  std::vector<std::string> id_to_token;
  // merge pair "left\x01right" -> rank (lower merges first)
  std::unordered_map<std::string, int> merges;
  bool lowercase = false;
  std::string byte_to_uni[256];  // UTF-8 of each byte's mapped codepoint
  std::unordered_map<std::string, std::vector<int>> cache;  // pretoken -> ids

  std::vector<int> last_ids;
  std::string last_tokens_joined;
};

void init_byte_map(BpeTokenizer& t) {
  // GPT-2 bytes_to_unicode: printable bytes keep their codepoint, the rest
  // are assigned 256, 257, ... in byte order.
  int next = 0;
  for (int b = 0; b < 256; b++) {
    bool printable = (b >= 33 && b <= 126) || (b >= 161 && b <= 172) ||
                     (b >= 174 && b <= 255);
    uint32_t cp = printable ? static_cast<uint32_t>(b)
                            : static_cast<uint32_t>(256 + next++);
    encode_utf8(cp, t.byte_to_uni[b]);
  }
}

// GPT-2 pre-tokenizer:
//   's|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+
// implemented as a hand scanner over codepoints (same match order).
std::vector<std::string> bpe_pretokenize(const std::string& text) {
  // Decode once into (codepoint, byte offset) pairs.
  std::vector<uint32_t> cps;
  std::vector<size_t> offs;
  size_t i = 0;
  while (i < text.size()) {
    offs.push_back(i);
    cps.push_back(decode_utf8(text, i));
  }
  offs.push_back(text.size());
  const size_t n = cps.size();

  auto slice = [&](size_t a, size_t b) {
    return text.substr(offs[a], offs[b] - offs[a]);
  };
  std::vector<std::string> out;
  size_t p = 0;
  while (p < n) {
    // contractions (no leading space)
    if (cps[p] == '\'' && p + 1 < n) {
      uint32_t c1 = cps[p + 1];
      if (c1 == 's' || c1 == 't' || c1 == 'm' || c1 == 'd') {
        out.push_back(slice(p, p + 2)); p += 2; continue;
      }
      if (p + 2 < n &&
          ((c1 == 'r' && cps[p + 2] == 'e') ||
           (c1 == 'v' && cps[p + 2] == 'e') ||
           (c1 == 'l' && cps[p + 2] == 'l'))) {
        out.push_back(slice(p, p + 3)); p += 3; continue;
      }
    }
    // " ?\p{L}+" / " ?\p{N}+" / " ?[^\s\p{L}\p{N}]+"
    size_t start = p;
    size_t q = p;
    if (cps[q] == ' ' && q + 1 < n && !is_bpe_space(cps[q + 1])) q++;
    if (q < n && is_letter(cps[q])) {
      while (q < n && is_letter(cps[q])) q++;
      out.push_back(slice(start, q)); p = q; continue;
    }
    if (q < n && is_number(cps[q])) {
      while (q < n && is_number(cps[q])) q++;
      out.push_back(slice(start, q)); p = q; continue;
    }
    if (q < n && !is_bpe_space(cps[q])) {
      while (q < n && !is_bpe_space(cps[q]) && !is_letter(cps[q]) &&
             !is_number(cps[q]))
        q++;
      out.push_back(slice(start, q)); p = q; continue;
    }
    // whitespace runs: "\s+(?!\S)" then "\s+"
    q = p;
    while (q < n && is_bpe_space(cps[q])) q++;
    if (q < n && q - p >= 2) {
      // followed by non-space: leave the last whitespace char for the
      // next token's optional leading space
      out.push_back(slice(p, q - 1));
      p = q - 1;
      // a trailing single non-' ' whitespace becomes its own \s+ token
      if (cps[p] != ' ') { out.push_back(slice(p, p + 1)); p += 1; }
      continue;
    }
    if (q == n) { out.push_back(slice(p, q)); p = q; continue; }
    // single whitespace followed by non-space
    if (cps[p] == ' ') {
      // handled by the " ?" branches above unless followed by space (ruled
      // out) — reaching here means ' ' followed by something the classes
      // all rejected; emit it alone.
      out.push_back(slice(p, p + 1)); p += 1; continue;
    }
    out.push_back(slice(p, p + 1));
    p += 1;
  }
  return out;
}

// Ranked merge loop on one pre-token (bytes already mapped to symbols).
std::vector<int> bpe_word(BpeTokenizer& t, const std::string& pretoken) {
  auto cached = t.cache.find(pretoken);
  if (cached != t.cache.end()) return cached->second;

  std::vector<std::string> symbols;
  for (unsigned char b : pretoken) symbols.push_back(t.byte_to_uni[b]);

  while (symbols.size() > 1) {
    int best_rank = INT32_MAX;
    size_t best_i = 0;
    for (size_t i = 0; i + 1 < symbols.size(); i++) {
      auto it = t.merges.find(symbols[i] + '\x01' + symbols[i + 1]);
      if (it != t.merges.end() && it->second < best_rank) {
        best_rank = it->second;
        best_i = i;
      }
    }
    if (best_rank == INT32_MAX) break;
    symbols = apply_merge(symbols, symbols[best_i], symbols[best_i + 1]);
  }

  std::vector<int> ids;
  ids.reserve(symbols.size());
  for (auto& s : symbols) {
    auto it = t.vocab.find(s);
    // HF ByteLevelBPE has no unk token: out-of-vocab symbols are DROPPED
    // (only reachable when the vocab lacks part of the byte alphabet).
    if (it != t.vocab.end()) ids.push_back(it->second);
  }
  if (t.cache.size() < 65536) t.cache.emplace(pretoken, ids);
  return ids;
}

// ---------------------------------------------------------------------------
// Byte-level BPE trainer (the ByteLevelBPETokenizer.train role:
// reference utils/build_vocab.py:39-58's BPE branch)
// ---------------------------------------------------------------------------

// Minimal JSON string escape for vocab.json keys (symbols are printable
// mapped-unicode; only quote/backslash need escaping).
std::string json_escape(const std::string& s) {
  std::string out;
  for (char c : s) {
    if (c == '"' || c == '\\') out.push_back('\\');
    out.push_back(c);
  }
  return out;
}

int bpe_train_impl(const std::string& files, const std::string& specials,
                   size_t vocab_size, long min_frequency, bool lowercase,
                   const std::string& out_dir) {
  BpeTokenizer map_only;
  init_byte_map(map_only);

  // 1. Pre-token counts across all files (GPT-2 pre-tokenizer, same as
  //    encode — training and encoding must agree on word boundaries).
  std::unordered_map<std::string, long> counts;
  std::stringstream fs(files);
  std::string path;
  while (std::getline(fs, path, '\n')) {
    if (path.empty()) continue;
    std::ifstream in(path);
    if (!in) return 2;
    std::string line;
    while (std::getline(in, line)) {
      if (lowercase) line = lower_utf8(line);
      for (auto& pre : bpe_pretokenize(line)) counts[pre] += 1;
    }
  }

  // 2. Words as byte-mapped symbol sequences.
  std::vector<std::pair<std::vector<std::string>, long>> words;
  words.reserve(counts.size());
  for (auto& kv : counts) {
    std::vector<std::string> symbols;
    for (unsigned char b : kv.first) symbols.push_back(map_only.byte_to_uni[b]);
    words.emplace_back(std::move(symbols), kv.second);
  }

  // 3. Vocab: specials, then the full 256-byte alphabet sorted by mapped
  //    codepoint (HF ByteLevel.alphabet() semantics), then merges in order.
  std::vector<std::string> vocab;
  std::stringstream ss(specials);
  std::string sp;
  while (std::getline(ss, sp, '\n'))
    if (!sp.empty()) vocab.push_back(sp);
  {
    std::vector<std::string> alphabet(map_only.byte_to_uni,
                                      map_only.byte_to_uni + 256);
    std::sort(alphabet.begin(), alphabet.end());
    vocab.insert(vocab.end(), alphabet.begin(), alphabet.end());
  }

  std::vector<std::pair<std::string, std::string>> merges_out;
  while (vocab.size() < vocab_size) {
    std::map<std::pair<std::string, std::string>, long> pair_counts;
    for (auto& [symbols, count] : words)
      for (size_t i = 0; i + 1 < symbols.size(); i++)
        pair_counts[{symbols[i], symbols[i + 1]}] += count;
    if (pair_counts.empty()) break;
    // Highest count; ties break to the lexicographically smallest pair
    // (std::map iteration order), deterministically.
    auto best = pair_counts.begin();
    for (auto it = pair_counts.begin(); it != pair_counts.end(); ++it)
      if (it->second > best->second) best = it;
    if (best->second < min_frequency) break;
    const auto [left, right] = best->first;
    merges_out.emplace_back(left, right);
    vocab.push_back(left + right);
    for (auto& [symbols, count] : words)
      symbols = apply_merge(symbols, left, right);
  }

  std::ofstream vout(out_dir + "/vocab.json");
  if (!vout) return 1;
  vout << "{";
  for (size_t i = 0; i < vocab.size(); i++) {
    if (i) vout << ",";
    vout << "\"" << json_escape(vocab[i]) << "\":" << i;
  }
  vout << "}\n";
  std::ofstream mout(out_dir + "/merges.txt");
  if (!mout) return 1;
  mout << "#version: 0.2\n";
  for (auto& [l, r] : merges_out) mout << l << " " << r << "\n";
  return 0;
}

}  // namespace

// ---------------------------------------------------------------------------
// C ABI
// ---------------------------------------------------------------------------

extern "C" {

void* wp_create(const char* vocab_path, int lowercase) {
  auto* t = new Tokenizer();
  t->lowercase = lowercase != 0;
  std::ifstream in(vocab_path);
  if (!in) { delete t; return nullptr; }
  std::string line;
  int index = 0;
  while (std::getline(in, line)) {
    if (!line.empty() && line.back() == '\r') line.pop_back();
    if (line.empty()) continue;
    t->vocab.emplace(line, index);
    t->id_to_token.push_back(line);
    t->max_token_len = std::max(t->max_token_len, line.size());
    index++;
  }
  auto unk = t->vocab.find("[UNK]");
  t->unk_id = unk == t->vocab.end() ? 0 : unk->second;
  return t;
}

void wp_free(void* handle) { delete static_cast<Tokenizer*>(handle); }

int wp_vocab_size(void* handle) {
  return static_cast<int>(static_cast<Tokenizer*>(handle)->id_to_token.size());
}

int wp_token_to_id(void* handle, const char* token) {
  auto* t = static_cast<Tokenizer*>(handle);
  auto it = t->vocab.find(token);
  return it == t->vocab.end() ? -1 : it->second;
}

const char* wp_id_to_token(void* handle, int id) {
  auto* t = static_cast<Tokenizer*>(handle);
  if (id < 0 || id >= static_cast<int>(t->id_to_token.size())) return "";
  return t->id_to_token[id].c_str();
}

// Encode text; returns number of tokens. Fetch results with wp_get_ids /
// wp_get_tokens (valid until the next encode on this handle).
// len-aware so embedded NUL bytes don't truncate the input (they are
// control chars the normalizer drops, but the text AFTER them must survive).
int wp_encode(void* handle, const char* text, int len) {
  auto* t = static_cast<Tokenizer*>(handle);
  t->last_ids.clear();
  t->last_tokens_joined.clear();
  std::vector<std::string> tokens;
  for (const auto& word :
       basic_tokenize(*t, std::string(text, static_cast<size_t>(len))))
    wordpiece(*t, word, t->last_ids, tokens);
  for (size_t i = 0; i < tokens.size(); i++) {
    if (i) t->last_tokens_joined.push_back('\n');
    t->last_tokens_joined += tokens[i];
  }
  return static_cast<int>(t->last_ids.size());
}

const int* wp_get_ids(void* handle) {
  return static_cast<Tokenizer*>(handle)->last_ids.data();
}

const char* wp_get_tokens(void* handle) {
  return static_cast<Tokenizer*>(handle)->last_tokens_joined.c_str();
}

// --- byte-level BPE ---------------------------------------------------------

// vocab_lines: '\n'-joined tokens in id order (byte-mapped strings contain
// no raw whitespace, so the framing is safe); merges_lines: '\n'-joined
// "left right" pairs in rank order (the merges.txt body).
void* bpe_create(const char* vocab_lines, const char* merges_lines,
                 int lowercase) {
  auto* t = new BpeTokenizer();
  t->lowercase = lowercase != 0;
  init_byte_map(*t);
  std::stringstream vs(vocab_lines);
  std::string line;
  while (std::getline(vs, line, '\n')) {
    t->vocab.emplace(line, static_cast<int>(t->id_to_token.size()));
    t->id_to_token.push_back(line);
  }
  std::stringstream ms(merges_lines);
  int rank = 0;
  bool first_line = true;
  while (std::getline(ms, line, '\n')) {
    // Only the leading "#version: ..." header is a comment — a merge whose
    // left symbol starts with '#' (e.g. "# #") is legitimate data.
    bool header = first_line && line.rfind("#version", 0) == 0;
    first_line = false;
    if (line.empty() || header) continue;
    size_t sp = line.find(' ');
    if (sp == std::string::npos) continue;
    t->merges.emplace(line.substr(0, sp) + '\x01' + line.substr(sp + 1),
                      rank++);
  }
  return t;
}

void bpe_free(void* handle) { delete static_cast<BpeTokenizer*>(handle); }

int bpe_vocab_size(void* handle) {
  return static_cast<int>(
      static_cast<BpeTokenizer*>(handle)->id_to_token.size());
}

int bpe_token_to_id(void* handle, const char* token) {
  auto* t = static_cast<BpeTokenizer*>(handle);
  auto it = t->vocab.find(token);
  return it == t->vocab.end() ? -1 : it->second;
}

const char* bpe_id_to_token(void* handle, int id) {
  auto* t = static_cast<BpeTokenizer*>(handle);
  if (id < 0 || id >= static_cast<int>(t->id_to_token.size())) return "";
  return t->id_to_token[id].c_str();
}

int bpe_encode(void* handle, const char* text_c, int len) {
  auto* t = static_cast<BpeTokenizer*>(handle);
  t->last_ids.clear();
  t->last_tokens_joined.clear();
  std::string text(text_c, static_cast<size_t>(len));
  if (t->lowercase) text = lower_utf8(text);
  for (const auto& pre : bpe_pretokenize(text)) {
    for (int id : bpe_word(*t, pre)) t->last_ids.push_back(id);
  }
  for (size_t i = 0; i < t->last_ids.size(); i++) {
    if (i) t->last_tokens_joined.push_back('\n');
    t->last_tokens_joined += t->id_to_token[t->last_ids[i]];
  }
  return static_cast<int>(t->last_ids.size());
}

const int* bpe_get_ids(void* handle) {
  return static_cast<BpeTokenizer*>(handle)->last_ids.data();
}

const char* bpe_get_tokens(void* handle) {
  return static_cast<BpeTokenizer*>(handle)->last_tokens_joined.c_str();
}

// Train a byte-level BPE; writes vocab.json + merges.txt into out_dir.
// Returns 0 on success, 1 on write failure, 2 on unreadable input.
int bpe_train(const char* files, const char* specials, int vocab_size,
              int min_frequency, int lowercase, const char* out_dir) {
  return bpe_train_impl(files, specials, static_cast<size_t>(vocab_size),
                        min_frequency, lowercase != 0, out_dir);
}

// Train a WordPiece vocab from newline-delimited text files.
// files: '\n'-joined list of paths. specials: '\n'-joined special tokens
// (placed first, [PAD] at 0 per reference utils/build_vocab.py:64-75).
// Returns 0 on success; writes one token per line to out_path.
int wp_train(const char* files, const char* specials, int vocab_size,
             int min_frequency, int lowercase, const char* out_path) {
  Tokenizer norm;
  norm.lowercase = lowercase != 0;
  TrainerState st;
  std::stringstream fs(files);
  std::string path;
  while (std::getline(fs, path, '\n'))
    if (!path.empty()) trainer_count_file(st, norm, path);

  std::vector<std::string> specials_list;
  std::stringstream ss(specials);
  std::string sp;
  while (std::getline(ss, sp, '\n'))
    if (!sp.empty()) specials_list.push_back(sp);

  auto vocab = trainer_run(st, static_cast<size_t>(vocab_size), specials_list,
                           min_frequency);
  std::ofstream out(out_path);
  if (!out) return 1;
  for (auto& tok : vocab) out << tok << "\n";
  return 0;
}

}  // extern "C"
