// Native BPE merge engine for the CLIP tokenizer.
//
// The reference relied on HF's tokenizer (Rust core); this framework's
// tokenizer is first-party. Pre-tokenization (regex word split, lowercase,
// GPT-2 byte->unicode mapping) stays in Python; the quadratic merge loop —
// the hot path when encoding long prompt lists — runs here.
//
// C API (ctypes-friendly):
//   bpe_create(tokens, ids, n_tokens, merges_l, merges_r, n_merges) -> handle
//     tokens[i] is a UTF-8 vocabulary string and ids[i] its id (ids need
//     not be dense: the synthetic test vocabularies put the special tokens
//     at CLIP's 49406 / 49407).
//   bpe_encode_word(handle, word, out_ids, max_out) -> n_ids
//     `word` is the byte-encoded word as UTF-8 *without* the </w> marker;
//     the engine appends </w> to the last symbol like CLIP's BPE.
//   bpe_destroy(handle)
//
// Build: g++ -O2 -shared -fPIC -std=c++17 bpe.cpp -o libbpe.so
// (leco_tpu_torch/native/__init__.py does, at first use).

#include <cstdint>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct PairHash {
  size_t operator()(const std::pair<std::string, std::string>& p) const {
    return std::hash<std::string>()(p.first) * 1000003u ^
           std::hash<std::string>()(p.second);
  }
};

struct BPE {
  std::unordered_map<std::string, int32_t> vocab;
  std::unordered_map<std::pair<std::string, std::string>, int32_t, PairHash>
      ranks;
};

// split a UTF-8 string into code points (as byte strings)
std::vector<std::string> utf8_chars(const char* s) {
  std::vector<std::string> out;
  const unsigned char* p = reinterpret_cast<const unsigned char*>(s);
  while (*p) {
    int len = 1;
    if ((*p & 0xF8) == 0xF0)
      len = 4;
    else if ((*p & 0xF0) == 0xE0)
      len = 3;
    else if ((*p & 0xE0) == 0xC0)
      len = 2;
    out.emplace_back(reinterpret_cast<const char*>(p), len);
    p += len;
  }
  return out;
}

}  // namespace

extern "C" {

void* bpe_create(const char* const* tokens, const int32_t* ids, int32_t n_tokens,
                 const char* const* merges_l, const char* const* merges_r,
                 int32_t n_merges) {
  auto* bpe = new BPE();
  bpe->vocab.reserve(n_tokens * 2);
  for (int32_t i = 0; i < n_tokens; ++i) bpe->vocab[tokens[i]] = ids[i];
  bpe->ranks.reserve(n_merges * 2);
  for (int32_t i = 0; i < n_merges; ++i)
    bpe->ranks[{merges_l[i], merges_r[i]}] = i;
  return bpe;
}

void bpe_destroy(void* handle) { delete static_cast<BPE*>(handle); }

int32_t bpe_encode_word(void* handle, const char* word, int32_t* out_ids,
                        int32_t max_out) {
  auto* bpe = static_cast<BPE*>(handle);
  std::vector<std::string> pieces = utf8_chars(word);
  if (pieces.empty()) return 0;
  pieces.back() += "</w>";

  while (pieces.size() > 1) {
    // find the lowest-rank adjacent pair
    int32_t best_rank = INT32_MAX;
    size_t best_i = 0;
    for (size_t i = 0; i + 1 < pieces.size(); ++i) {
      auto it = bpe->ranks.find({pieces[i], pieces[i + 1]});
      if (it != bpe->ranks.end() && it->second < best_rank) {
        best_rank = it->second;
        best_i = i;
      }
    }
    if (best_rank == INT32_MAX) break;
    // merge ALL occurrences of that pair, left to right (BPE semantics)
    const std::string first = pieces[best_i];
    const std::string second = pieces[best_i + 1];
    std::vector<std::string> next;
    next.reserve(pieces.size());
    for (size_t i = 0; i < pieces.size();) {
      if (i + 1 < pieces.size() && pieces[i] == first &&
          pieces[i + 1] == second) {
        next.push_back(first + second);
        i += 2;
      } else {
        next.push_back(pieces[i]);
        i += 1;
      }
    }
    pieces.swap(next);
  }

  int32_t n = 0;
  for (const auto& piece : pieces) {
    if (n >= max_out) break;
    auto it = bpe->vocab.find(piece);
    out_ids[n++] = it == bpe->vocab.end() ? -1 : it->second;
  }
  return n;
}

}  // extern "C"
