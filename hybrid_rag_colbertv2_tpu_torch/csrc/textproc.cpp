// Native text processing: word tokenization + stopword filter + Porter
// stemming — the host-side hot loop of BM25 index builds (the reference
// delegates this to the bm25s/PyStemmer wheels; here it is first-party).
//
// The PyTorch port's own copy of the JAX package's csrc/textproc.cpp,
// built by hybrid_rag_colbertv2_tpu_torch/utils/native.py with g++ at
// first use. Contract: byte-identical output to the pure-Python
// implementation in hybrid_rag_colbertv2_tpu_torch/index/textproc.py
// (tested in tests/test_torch_native.py). Exposed via a C ABI for ctypes.
//
// API: documents arrive joined by '\x1e'; the result is stemmed tokens
// joined by ' ' within a document and '\x1e' between documents.

#include <algorithm>
#include <cctype>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <string>
#include <unordered_map>
#include <unordered_set>
#include <vector>

namespace {

const std::unordered_set<std::string>& stopwords() {
  static const std::unordered_set<std::string>* s =
      new std::unordered_set<std::string>{
          "a", "about", "above", "after", "again", "against", "all", "am",
          "an", "and", "any", "are", "aren't", "as", "at", "be", "because",
          "been", "before", "being", "below", "between", "both", "but", "by",
          "can't", "cannot", "could", "couldn't", "did", "didn't", "do",
          "does", "doesn't", "doing", "don't", "down", "during", "each",
          "few", "for", "from", "further", "had", "hadn't", "has", "hasn't",
          "have", "haven't", "having", "he", "he'd", "he'll", "he's", "her",
          "here", "here's", "hers", "herself", "him", "himself", "his",
          "how", "how's", "i", "i'd", "i'll", "i'm", "i've", "if", "in",
          "into", "is", "isn't", "it", "it's", "its", "itself", "let's",
          "me", "more", "most", "mustn't", "my", "myself", "no", "nor",
          "not", "of", "off", "on", "once", "only", "or", "other", "ought",
          "our", "ours", "ourselves", "out", "over", "own", "same",
          "shan't", "she", "she'd", "she'll", "she's", "should",
          "shouldn't", "so", "some", "such", "than", "that", "that's",
          "the", "their", "theirs", "them", "themselves", "then", "there",
          "there's", "these", "they", "they'd", "they'll", "they're",
          "they've", "this", "those", "through", "to", "too", "under",
          "until", "up", "very", "was", "wasn't", "we", "we'd", "we'll",
          "we're", "we've", "were", "weren't", "what", "what's", "when",
          "when's", "where", "where's", "which", "while", "who", "who's",
          "whom", "why", "why's", "with", "won't", "would", "wouldn't",
          "you", "you'd", "you'll", "you're", "you've", "your", "yours",
          "yourself", "yourselves",
          // apostrophe-stripped contraction fragments the tokenizer
          // actually produces ("don't" -> "don") — mirrors textproc.py
          "ain", "aren", "couldn", "didn", "doesn", "don", "hadn", "hasn",
          "haven", "isn", "ll", "ma", "mightn", "mustn", "needn", "re",
          "shan", "shouldn", "ve", "wasn", "weren", "won", "wouldn"};
  return *s;
}

// ---- Porter (1980) stemmer — mirrors textproc.py rule for rule ---------

inline bool is_vowel_char(char c) {
  return c == 'a' || c == 'e' || c == 'i' || c == 'o' || c == 'u';
}

bool is_cons(const std::string& w, int i) {
  char c = w[i];
  if (is_vowel_char(c)) return false;
  if (c == 'y') return i == 0 ? true : !is_cons(w, i - 1);
  return true;
}

int measure(const std::string& stem) {
  int m = 0;
  bool prev_vowel = false;
  for (int i = 0; i < (int)stem.size(); ++i) {
    bool cons = is_cons(stem, i);
    if (cons && prev_vowel) ++m;
    prev_vowel = !cons;
  }
  return m;
}

bool has_vowel(const std::string& stem) {
  for (int i = 0; i < (int)stem.size(); ++i)
    if (!is_cons(stem, i)) return true;
  return false;
}

bool ends_double_cons(const std::string& w) {
  int n = (int)w.size();
  return n >= 2 && w[n - 1] == w[n - 2] && is_cons(w, n - 1);
}

bool ends_cvc(const std::string& w) {
  int n = (int)w.size();
  if (n < 3) return false;
  int i = n - 1;
  char c = w[i];
  return is_cons(w, i) && !is_cons(w, i - 1) && is_cons(w, i - 2) &&
         c != 'w' && c != 'x' && c != 'y';
}

inline bool ends_with(const std::string& w, const char* suf) {
  size_t n = std::strlen(suf);
  return w.size() >= n && 0 == w.compare(w.size() - n, n, suf);
}

std::string step1a(std::string w) {
  if (ends_with(w, "sses")) return w.substr(0, w.size() - 2);
  if (ends_with(w, "ies")) return w.substr(0, w.size() - 2);
  if (ends_with(w, "ss")) return w;
  if (ends_with(w, "s")) return w.substr(0, w.size() - 1);
  return w;
}

std::string step1b(std::string w) {
  if (ends_with(w, "eed")) {
    if (measure(w.substr(0, w.size() - 3)) > 0)
      return w.substr(0, w.size() - 1);
    return w;
  }
  bool flag = false;
  if (ends_with(w, "ed") && has_vowel(w.substr(0, w.size() - 2))) {
    w = w.substr(0, w.size() - 2);
    flag = true;
  } else if (ends_with(w, "ing") && has_vowel(w.substr(0, w.size() - 3))) {
    w = w.substr(0, w.size() - 3);
    flag = true;
  }
  if (flag) {
    if (ends_with(w, "at") || ends_with(w, "bl") || ends_with(w, "iz"))
      return w + "e";
    if (ends_double_cons(w)) {
      char last = w[w.size() - 1];
      if (last != 'l' && last != 's' && last != 'z')
        return w.substr(0, w.size() - 1);
      return w;
    }
    if (measure(w) == 1 && ends_cvc(w)) return w + "e";
  }
  return w;
}

std::string step1c(std::string w) {
  if (ends_with(w, "y") && has_vowel(w.substr(0, w.size() - 1)))
    return w.substr(0, w.size() - 1) + "i";
  return w;
}

struct Rule { const char* suf; const char* rep; };

const Rule kStep2[] = {
    {"ational", "ate"}, {"tional", "tion"}, {"enci", "ence"},
    {"anci", "ance"},   {"izer", "ize"},    {"abli", "able"},
    {"alli", "al"},     {"entli", "ent"},   {"eli", "e"},
    {"ousli", "ous"},   {"ization", "ize"}, {"ation", "ate"},
    {"ator", "ate"},    {"alism", "al"},    {"iveness", "ive"},
    {"fulness", "ful"}, {"ousness", "ous"}, {"aliti", "al"},
    {"iviti", "ive"},   {"biliti", "ble"},
};

const Rule kStep3[] = {
    {"icate", "ic"}, {"ative", ""}, {"alize", "al"}, {"iciti", "ic"},
    {"ical", "ic"},  {"ful", ""},   {"ness", ""},
};

std::string apply_rules(std::string w, const Rule* rules, int n) {
  for (int i = 0; i < n; ++i) {
    if (ends_with(w, rules[i].suf)) {
      std::string stem = w.substr(0, w.size() - std::strlen(rules[i].suf));
      if (measure(stem) > 0) return stem + rules[i].rep;
      return w;
    }
  }
  return w;
}

const char* kStep4[] = {"al",  "ance", "ence", "er",  "ic",  "able", "ible",
                        "ant", "ement", "ment", "ent", "ion", "ou",   "ism",
                        "ate", "iti",  "ous",  "ive", "ize"};

std::string step4(std::string w) {
  for (const char* suf : kStep4) {
    if (ends_with(w, suf)) {
      std::string stem = w.substr(0, w.size() - std::strlen(suf));
      if (0 == std::strcmp(suf, "ion")) {
        if (stem.empty() ||
            (stem.back() != 's' && stem.back() != 't'))
          continue;
      }
      if (measure(stem) > 1) return stem;
      return w;
    }
  }
  return w;
}

std::string step5(std::string w) {
  if (ends_with(w, "e")) {
    std::string stem = w.substr(0, w.size() - 1);
    int m = measure(stem);
    if (m > 1 || (m == 1 && !ends_cvc(stem))) w = stem;
  }
  if (measure(w) > 1 && ends_with(w, "ll")) w = w.substr(0, w.size() - 1);
  return w;
}

std::string porter_stem(const std::string& word) {
  if (word.size() <= 2) return word;
  std::string w = step1a(word);
  w = step1b(w);
  w = step1c(w);
  w = apply_rules(w, kStep2, sizeof(kStep2) / sizeof(Rule));
  w = apply_rules(w, kStep3, sizeof(kStep3) / sizeof(Rule));
  w = step4(w);
  w = step5(w);
  return w;
}

// ---- Snowball "english" (Porter2) stemmer --------------------------------
// Mirrors textproc.py SnowballStemmer statement for statement (official
// fixed-R1/R2 integer semantics, as in libstemmer/PyStemmer — the stemmer
// the reference intends via stemmer="english"). Byte-identical contract
// tested in tests/test_native.py. Within the marked word, lowercase 'y'
// counts as a vowel and the consonant marker 'Y' does not.

inline bool sb_vowel(char c) {
  return c == 'a' || c == 'e' || c == 'i' || c == 'o' || c == 'u' ||
         c == 'y';
}

bool sb_short_syllable_at_end(const std::string& w) {
  int n = (int)w.size();
  if (n >= 3) {
    char a = w[n - 1];
    return !sb_vowel(a) && a != 'w' && a != 'x' && a != 'Y' &&
           sb_vowel(w[n - 2]) && !sb_vowel(w[n - 3]);
  }
  if (n == 2) return sb_vowel(w[0]) && !sb_vowel(w[1]);
  return false;
}

const std::unordered_map<std::string, std::string>& sb_special() {
  static const auto* m = new std::unordered_map<std::string, std::string>{
      {"skis", "ski"},       {"skies", "sky"},      {"dying", "die"},
      {"lying", "lie"},      {"tying", "tie"},      {"idly", "idl"},
      {"gently", "gentl"},   {"ugly", "ugli"},      {"early", "earli"},
      {"only", "onli"},      {"singly", "singl"},   {"sky", "sky"},
      {"news", "news"},      {"howe", "howe"},      {"atlas", "atlas"},
      {"cosmos", "cosmos"},  {"bias", "bias"},      {"andes", "andes"},
      {"inning", "inning"},  {"innings", "inning"}, {"outing", "outing"},
      {"outings", "outing"}, {"canning", "canning"},
      {"cannings", "canning"}, {"herring", "herring"},
      {"herrings", "herring"}, {"earring", "earring"},
      {"earrings", "earring"}, {"proceed", "proceed"},
      {"proceeds", "proceed"}, {"proceeded", "proceed"},
      {"proceeding", "proceed"}, {"exceed", "exceed"},
      {"exceeds", "exceed"},   {"exceeded", "exceed"},
      {"exceeding", "exceed"}, {"succeed", "succeed"},
      {"succeeds", "succeed"}, {"succeeded", "succeed"},
      {"succeeding", "succeed"}};
  return *m;
}

const Rule kSbStep2[] = {
    {"ization", "ize"}, {"ational", "ate"}, {"fulness", "ful"},
    {"ousness", "ous"}, {"iveness", "ive"}, {"tional", "tion"},
    {"biliti", "ble"},  {"lessli", "less"}, {"entli", "ent"},
    {"ation", "ate"},   {"alism", "al"},    {"aliti", "al"},
    {"ousli", "ous"},   {"iviti", "ive"},   {"fulli", "ful"},
    {"enci", "ence"},   {"anci", "ance"},   {"abli", "able"},
    {"izer", "ize"},    {"ator", "ate"},    {"alli", "al"},
    {"bli", "ble"},     {"ogi", "og"},      {"li", ""},
};

const Rule kSbStep3[] = {
    {"ational", "ate"}, {"tional", "tion"}, {"alize", "al"},
    {"icate", "ic"},    {"iciti", "ic"},    {"ative", ""},
    {"ical", "ic"},     {"ness", ""},       {"ful", ""},
};

const char* kSbStep4[] = {"ement", "ance", "ence", "able", "ible", "ment",
                          "ant",   "ent",  "ism",  "ate",  "iti",  "ous",
                          "ive",   "ize",  "ion",  "al",   "er",   "ic"};

int sb_region_after_prefix(const std::string& w) {
  if (w.rfind("gener", 0) == 0 || w.rfind("arsen", 0) == 0) return 5;
  if (w.rfind("commun", 0) == 0) return 6;
  for (int i = 1; i < (int)w.size(); ++i)
    if (!sb_vowel(w[i]) && sb_vowel(w[i - 1])) return i + 1;
  return (int)w.size();
}

std::string sb_step0(std::string w) {
  for (const char* suf : {"'s'", "'s", "'"}) {
    if (ends_with(w, suf)) return w.substr(0, w.size() - std::strlen(suf));
  }
  return w;
}

bool sb_any_vowel(const std::string& w, int end) {
  for (int i = 0; i < end && i < (int)w.size(); ++i)
    if (sb_vowel(w[i])) return true;
  return false;
}

std::string sb_step1a(std::string w) {
  if (ends_with(w, "sses")) return w.substr(0, w.size() - 2);
  if (ends_with(w, "ied") || ends_with(w, "ies"))
    return w.size() > 4 ? w.substr(0, w.size() - 2)
                        : w.substr(0, w.size() - 1);
  if (ends_with(w, "us") || ends_with(w, "ss")) return w;
  if (ends_with(w, "s")) {
    if (sb_any_vowel(w, (int)w.size() - 2)) return w.substr(0, w.size() - 1);
  }
  return w;
}

std::string sb_step1b(std::string w, int p1) {
  for (const char* suf : {"eedly", "eed"}) {
    if (ends_with(w, suf)) {
      size_t n = std::strlen(suf);
      if ((int)(w.size() - n) >= p1) return w.substr(0, w.size() - n) + "ee";
      return w;
    }
  }
  for (const char* suf : {"ingly", "edly", "ing", "ed"}) {
    if (ends_with(w, suf)) {
      std::string stem = w.substr(0, w.size() - std::strlen(suf));
      if (!sb_any_vowel(stem, (int)stem.size())) return w;
      if (ends_with(stem, "at") || ends_with(stem, "bl") ||
          ends_with(stem, "iz"))
        return stem + "e";
      static const char* kDoubles[] = {"bb", "dd", "ff", "gg", "mm",
                                       "nn", "pp", "rr", "tt"};
      for (const char* d : kDoubles)
        if (ends_with(stem, d)) return stem.substr(0, stem.size() - 1);
      if (p1 >= (int)stem.size() && sb_short_syllable_at_end(stem))
        return stem + "e";
      return stem;
    }
  }
  return w;
}

std::string sb_step1c(std::string w) {
  if (w.size() > 2 && (w.back() == 'y' || w.back() == 'Y') &&
      !sb_vowel(w[w.size() - 2]))
    return w.substr(0, w.size() - 1) + "i";
  return w;
}

std::string sb_step2(std::string w, int p1) {
  for (const Rule& r : kSbStep2) {
    if (ends_with(w, r.suf)) {
      size_t n = std::strlen(r.suf);
      if ((int)(w.size() - n) < p1) return w;
      if (0 == std::strcmp(r.suf, "ogi"))
        return w[w.size() - 4] == 'l' ? w.substr(0, w.size() - 1) : w;
      if (0 == std::strcmp(r.suf, "li")) {
        char c = w[w.size() - 3];
        static const std::string li_ending = "cdeghkmnrt";
        return li_ending.find(c) != std::string::npos
                   ? w.substr(0, w.size() - 2)
                   : w;
      }
      return w.substr(0, w.size() - n) + r.rep;
    }
  }
  return w;
}

std::string sb_step3(std::string w, int p1, int p2) {
  for (const Rule& r : kSbStep3) {
    if (ends_with(w, r.suf)) {
      size_t n = std::strlen(r.suf);
      if ((int)(w.size() - n) < p1) return w;
      if (0 == std::strcmp(r.suf, "ative"))
        return (int)(w.size() - 5) >= p2 ? w.substr(0, w.size() - 5) : w;
      return w.substr(0, w.size() - n) + r.rep;
    }
  }
  return w;
}

std::string sb_step4(std::string w, int p2) {
  for (const char* suf : kSbStep4) {
    if (ends_with(w, suf)) {
      size_t n = std::strlen(suf);
      if ((int)(w.size() - n) < p2) return w;
      if (0 == std::strcmp(suf, "ion")) {
        char c = w[w.size() - 4];
        return (c == 's' || c == 't') ? w.substr(0, w.size() - 3) : w;
      }
      return w.substr(0, w.size() - n);
    }
  }
  return w;
}

std::string sb_step5(std::string w, int p1, int p2) {
  if (ends_with(w, "e")) {
    if ((int)w.size() - 1 >= p2) return w.substr(0, w.size() - 1);
    if ((int)w.size() - 1 >= p1 &&
        !sb_short_syllable_at_end(w.substr(0, w.size() - 1)))
      return w.substr(0, w.size() - 1);
    return w;
  }
  if (ends_with(w, "ll") && (int)w.size() - 1 >= p2)
    return w.substr(0, w.size() - 1);
  return w;
}

std::string snowball_stem(const std::string& word) {
  if (word.size() <= 2) return word;
  const auto& special = sb_special();
  auto it = special.find(word);
  if (it != special.end()) return it->second;
  std::string w = word;
  if (w[0] == '\'') {
    w = w.substr(1);
    if (w.size() <= 2) return w;
  }
  // mark consonant-y as Y: at the start, or right after a vowel
  if (w[0] == 'y') w[0] = 'Y';
  for (size_t i = 1; i < w.size(); ++i)
    if (w[i] == 'y' && sb_vowel(w[i - 1])) w[i] = 'Y';

  int p1 = sb_region_after_prefix(w);
  int p2 = (int)w.size();
  for (int i = p1 + 1; i < (int)w.size(); ++i) {
    if (!sb_vowel(w[i]) && sb_vowel(w[i - 1])) {
      p2 = i + 1;
      break;
    }
  }

  w = sb_step0(std::move(w));
  w = sb_step1a(std::move(w));
  w = sb_step1b(std::move(w), p1);
  w = sb_step1c(std::move(w));
  w = sb_step2(std::move(w), p1);
  w = sb_step3(std::move(w), p1, p2);
  w = sb_step4(std::move(w), p2);
  w = sb_step5(std::move(w), p1, p2);
  for (char& c : w)
    if (c == 'Y') c = 'y';
  return w;
}

// stem algorithm selector: 0 = none, 1 = snowball (default), 2 = porter
std::string stem_word(const std::string& w, int32_t algo) {
  return algo == 2 ? porter_stem(w) : snowball_stem(w);
}

// ---- tokenizer: [a-z0-9]{2,} over lowercased text ------------------------

void tokenize_doc(const char* begin, const char* end, int32_t stem_algo,
                  std::unordered_map<std::string, std::string>* memo,
                  std::string* out) {
  std::string tok;
  bool first = true;
  const auto& stops = stopwords();
  auto flush = [&]() {
    if (tok.empty()) return;
    // >= 2 chars (bm25s \b\w\w+\b parity; mirrors textproc.py _WORD_RE)
    if (tok.size() >= 2 && !stops.count(tok)) {
      if (!first) out->push_back(' ');
      first = false;
      if (stem_algo != 0) {
        auto it = memo->find(tok);
        if (it == memo->end())
          it = memo->emplace(tok, stem_word(tok, stem_algo)).first;
        out->append(it->second);
      } else {
        out->append(tok);
      }
    }
    tok.clear();
  };
  for (const char* p = begin; p != end; ++p) {
    unsigned char c = (unsigned char)*p;
    unsigned char lc = (c >= 'A' && c <= 'Z') ? c + 32 : c;
    if ((lc >= 'a' && lc <= 'z') || (lc >= '0' && lc <= '9')) {
      tok.push_back((char)lc);
    } else {
      flush();
    }
  }
  flush();
}

// ---- postings builder: the BM25 index-build hot loop ---------------------
//
// Tokenize+stem every document and aggregate (term, doc) -> tf triples in
// one pass, interning terms into integer ids as they appear. The numeric
// half of the build (idf, BM25 weights, postings cap, CSR assembly) stays
// in numpy (index/lexical.py) so results are bit-identical to the
// pure-Python path by construction — this function only replaces the
// string-heavy part (tokenize, vocab unique, pair aggregation), which is
// where a Python build spends its time.

struct PostingsBuild {
  std::vector<std::string> terms;          // id -> term (insertion order)
  std::vector<int32_t> doc_lens;           // kept tokens per doc
  std::vector<int32_t> tids, dids, tfs;    // triples, doc-major
};

void tokenize_doc_ids(const char* begin, const char* end, int32_t stem_algo,
                      std::unordered_map<std::string, int32_t>* tok2id,
                      std::unordered_map<std::string, int32_t>* term2id,
                      std::vector<std::string>* terms,
                      std::vector<int32_t>* ids_out) {
  std::string tok;
  const auto& stops = stopwords();
  auto intern = [&](const std::string& t) -> int32_t {
    auto it = tok2id->find(t);
    if (it != tok2id->end()) return it->second;
    std::string term = stem_algo != 0 ? stem_word(t, stem_algo) : t;
    int32_t id;
    auto jt = term2id->find(term);
    if (jt != term2id->end()) {
      id = jt->second;
    } else {
      id = (int32_t)terms->size();
      terms->push_back(term);
      term2id->emplace(std::move(term), id);
    }
    tok2id->emplace(t, id);
    return id;
  };
  auto flush = [&]() {
    if (tok.size() >= 2 && !stops.count(tok)) ids_out->push_back(intern(tok));
    tok.clear();
  };
  for (const char* p = begin; p != end; ++p) {
    unsigned char c = (unsigned char)*p;
    unsigned char lc = (c >= 'A' && c <= 'Z') ? c + 32 : c;
    if ((lc >= 'a' && lc <= 'z') || (lc >= '0' && lc <= '9')) {
      tok.push_back((char)lc);
    } else {
      flush();
    }
  }
  flush();
}

void build_postings(const char* data, int64_t len, int32_t stem_algo,
                    PostingsBuild* b) {
  std::unordered_map<std::string, int32_t> tok2id, term2id;
  const char* p = data;
  const char* end = data + len;
  std::vector<int32_t> ids;
  int32_t di = 0;
  while (p <= end) {
    const char* sep = (const char*)memchr(p, '\x1e', end - p);
    const char* doc_end = sep ? sep : end;
    ids.clear();
    tokenize_doc_ids(p, doc_end, stem_algo, &tok2id, &term2id, &b->terms,
                     &ids);
    b->doc_lens.push_back((int32_t)ids.size());
    // run-length over the sorted ids -> per-doc tf
    std::sort(ids.begin(), ids.end());
    for (size_t i = 0; i < ids.size();) {
      size_t j = i + 1;
      while (j < ids.size() && ids[j] == ids[i]) ++j;
      b->tids.push_back(ids[i]);
      b->dids.push_back(di);
      b->tfs.push_back((int32_t)(j - i));
      i = j;
    }
    ++di;
    if (!sep) break;
    p = sep + 1;
  }
  // remap insertion-order ids to LEXICOGRAPHIC ids (np.unique parity —
  // terms are pure ASCII [a-z0-9]+ so bytewise order == Python str order)
  const int32_t v = (int32_t)b->terms.size();
  std::vector<int32_t> order(v);
  for (int32_t i = 0; i < v; ++i) order[i] = i;
  std::sort(order.begin(), order.end(), [&](int32_t a, int32_t c) {
    return b->terms[a] < b->terms[c];
  });
  std::vector<int32_t> rank(v);
  std::vector<std::string> sorted_terms(v);
  for (int32_t i = 0; i < v; ++i) {
    rank[order[i]] = i;
    sorted_terms[i] = std::move(b->terms[order[i]]);
  }
  b->terms = std::move(sorted_terms);
  for (auto& t : b->tids) t = rank[t];
  // triples are doc-major; a STABLE sort by term id leaves docs ascending
  // within each term — exactly numpy's (term, doc) pair order
  std::vector<int64_t> idx(b->tids.size());
  for (size_t i = 0; i < idx.size(); ++i) idx[i] = (int64_t)i;
  std::stable_sort(idx.begin(), idx.end(), [&](int64_t a, int64_t c) {
    return b->tids[a] < b->tids[c];
  });
  std::vector<int32_t> t2(idx.size()), d2(idx.size()), f2(idx.size());
  for (size_t i = 0; i < idx.size(); ++i) {
    t2[i] = b->tids[idx[i]];
    d2[i] = b->dids[idx[i]];
    f2[i] = b->tfs[idx[i]];
  }
  b->tids = std::move(t2);
  b->dids = std::move(d2);
  b->tfs = std::move(f2);
}

}  // namespace

extern "C" {

// docs joined by '\x1e' -> stemmed tokens (' ' within doc, '\x1e' between).
// stem_algo: 0 = none, 1 = snowball english (default), 2 = porter 1980.
// Returns a malloc'd buffer the caller frees with hrag_free; *out_len gets
// the byte length.
char* hrag_tokenize_corpus(const char* data, int64_t len, int32_t stem_algo,
                           int64_t* out_len) {
  std::string out;
  out.reserve((size_t)len);
  std::unordered_map<std::string, std::string> memo;
  const char* p = data;
  const char* end = data + len;
  bool first_doc = true;
  while (p <= end) {
    const char* sep = (const char*)memchr(p, '\x1e', end - p);
    const char* doc_end = sep ? sep : end;
    if (!first_doc) out.push_back('\x1e');
    first_doc = false;
    tokenize_doc(p, doc_end, stem_algo, &memo, &out);
    if (!sep) break;
    p = sep + 1;
  }
  char* buf = (char*)malloc(out.size() + 1);
  memcpy(buf, out.data(), out.size());
  buf[out.size()] = 0;
  *out_len = (int64_t)out.size();
  return buf;
}

// single-word stem (testing / query path); algo as above (0 -> snowball)
char* hrag_stem(const char* word, int64_t len, int32_t algo,
                int64_t* out_len) {
  std::string w(word, (size_t)len);
  std::string s = stem_word(w, algo == 0 ? 1 : algo);
  char* buf = (char*)malloc(s.size() + 1);
  memcpy(buf, s.data(), s.size());
  buf[s.size()] = 0;
  *out_len = (int64_t)s.size();
  return buf;
}

// docs joined by '\x1e' -> packed postings buffer (caller frees with
// hrag_free; *out_len gets the byte length):
//   int64[4] header: n_docs, n_terms, nnz, vocab_bytes
//   char vocab[vocab_bytes]: sorted terms joined by ' ', zero-padded to 8
//   int32 doc_lens[n_docs]   (kept-token count per doc)
//   int32 tids[nnz]          (lexicographic term ids, (term, doc) sorted)
//   int32 dids[nnz]
//   int32 tfs[nnz]
// ...each int32 block zero-padded to an 8-byte boundary.
char* hrag_build_postings(const char* data, int64_t len, int32_t stem_algo,
                          int64_t* out_len) {
  PostingsBuild b;
  build_postings(data, len, stem_algo, &b);
  std::string vocab;
  for (size_t i = 0; i < b.terms.size(); ++i) {
    if (i) vocab.push_back(' ');
    vocab += b.terms[i];
  }
  auto pad8 = [](int64_t x) { return (x + 7) & ~int64_t(7); };
  const int64_t n_docs = (int64_t)b.doc_lens.size();
  const int64_t n_terms = (int64_t)b.terms.size();
  const int64_t nnz = (int64_t)b.tids.size();
  const int64_t vocab_bytes = (int64_t)vocab.size();
  int64_t off_vocab = 32;
  int64_t off_lens = off_vocab + pad8(vocab_bytes);
  int64_t off_tids = off_lens + pad8(n_docs * 4);
  int64_t off_dids = off_tids + pad8(nnz * 4);
  int64_t off_tfs = off_dids + pad8(nnz * 4);
  int64_t total = off_tfs + pad8(nnz * 4);
  char* buf = (char*)calloc(1, (size_t)total);
  int64_t header[4] = {n_docs, n_terms, nnz, vocab_bytes};
  memcpy(buf, header, sizeof(header));
  memcpy(buf + off_vocab, vocab.data(), (size_t)vocab_bytes);
  if (n_docs) memcpy(buf + off_lens, b.doc_lens.data(), (size_t)n_docs * 4);
  if (nnz) {
    memcpy(buf + off_tids, b.tids.data(), (size_t)nnz * 4);
    memcpy(buf + off_dids, b.dids.data(), (size_t)nnz * 4);
    memcpy(buf + off_tfs, b.tfs.data(), (size_t)nnz * 4);
  }
  *out_len = total;
  return buf;
}

void hrag_free(char* p) { free(p); }

int32_t hrag_abi_version() { return 3; }

}  // extern "C"
