// Kuzmin Data-S1 TSV tokenizer: the native tier of the port's data layer
// (a copy of the reference's native/kuzmin_parser.cpp).
//
// Mirrors the semantics of data/kuzmin.py exactly (that module is the
// source of truth; tests/test_torch_native.py asserts identical rows):
//   - header columns matched case-insensitively with whitespace squeeze,
//     exact alias first then prefix fallback;
//   - rows filtered on "Combined mutant type";
//   - "Query strain ID" split on '+' into exactly two genes;
//   - allele suffixes stripped at the first '-' or '_', names upper-cased;
//   - label = 1 iff p < p_cutoff and (|tau| > tau_cutoff, or
//     tau < -tau_cutoff in negative mode);
//   - optional dedup on the sorted gene triple, keeping the first row.
//
// C ABI for ctypes: the result is a '\n'-separated blob of
// "GENEA\tGENEB\tGENEC" lines plus an int32 label array.
//
// Built at first use by native/binding.py (g++ -O2 -std=c++17 -fPIC -shared).

#include <algorithm>
#include <array>
#include <cctype>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <fstream>
#include <set>
#include <sstream>
#include <string>
#include <vector>

namespace {

std::string norm_col(const std::string& s) {
  std::string out;
  bool space = false;
  for (char c : s) {
    if (std::isspace(static_cast<unsigned char>(c))) {
      space = !out.empty();
      continue;
    }
    if (space) out.push_back(' ');
    space = false;
    out.push_back(std::tolower(static_cast<unsigned char>(c)));
  }
  return out;
}

int find_col(const std::vector<std::string>& header,
             const std::vector<std::string>& aliases) {
  std::vector<std::string> normed;
  normed.reserve(header.size());
  for (const auto& h : header) normed.push_back(norm_col(h));
  for (const auto& a : aliases) {
    for (size_t i = 0; i < normed.size(); ++i)
      if (normed[i] == a) return static_cast<int>(i);
  }
  for (const auto& a : aliases) {
    for (size_t i = 0; i < normed.size(); ++i)
      if (normed[i].rfind(a, 0) == 0) return static_cast<int>(i);
  }
  return -1;
}

std::vector<std::string> split_tab(const std::string& line) {
  std::vector<std::string> out;
  size_t start = 0;
  while (true) {
    size_t tab = line.find('\t', start);
    if (tab == std::string::npos) {
      out.push_back(line.substr(start));
      break;
    }
    out.push_back(line.substr(start, tab - start));
    start = tab + 1;
  }
  return out;
}

std::string normalize_gene(const std::string& token, bool strip_allele) {
  size_t b = 0, e = token.size();
  while (b < e && std::isspace(static_cast<unsigned char>(token[b]))) ++b;
  while (e > b && std::isspace(static_cast<unsigned char>(token[e - 1]))) --e;
  std::string t = token.substr(b, e - b);
  if (strip_allele) {
    size_t cut = t.find_first_of("-_");
    if (cut != std::string::npos) t.resize(cut);
  }
  std::transform(t.begin(), t.end(), t.begin(),
                 [](unsigned char c) { return std::toupper(c); });
  return t;
}

bool parse_double(const std::string& s, double* out) {
  if (s.empty()) return false;
  char* end = nullptr;
  *out = std::strtod(s.c_str(), &end);
  // Skip trailing whitespace; reject if anything else remains (Python float()
  // semantics).
  while (end && *end && std::isspace(static_cast<unsigned char>(*end))) ++end;
  return end && *end == '\0' && end != s.c_str();
}

struct ParseResult {
  std::string names;            // "A\tB\tC\n" per row
  std::vector<int32_t> labels;
  std::string error;
};

}  // namespace

extern "C" {

// Returns an opaque handle (nullptr on allocation failure).  Check
// tip_result_error() for parse errors.
void* tip_parse_kuzmin(const char* path, double p_cutoff, double tau_cutoff,
                       int tau_mode_negative, const char* mutant_type,
                       int strip_allele, int dedup) {
  auto* res = new (std::nothrow) ParseResult();
  if (!res) return nullptr;
  std::ifstream in(path);
  if (!in) {
    res->error = std::string("cannot open file: ") + path;
    return res;
  }
  std::string line;
  if (!std::getline(in, line)) return res;  // empty file -> zero rows
  if (!line.empty() && line.back() == '\r') line.pop_back();

  const std::vector<std::string> kQuery = {"query strain id", "query strain",
                                           "query"};
  const std::vector<std::string> kArray = {"array strain id", "array strain",
                                           "array"};
  const std::vector<std::string> kType = {"combined mutant type",
                                          "mutant type"};
  const std::vector<std::string> kTau = {
      "adjusted genetic interaction score (epsilon or tau)",
      "adjusted genetic interaction score", "tau"};
  const std::vector<std::string> kRaw = {
      "raw genetic interaction score (epsilon)",
      "raw genetic interaction score", "epsilon"};
  const std::vector<std::string> kPval = {"p-value", "pvalue", "p value"};

  auto header = split_tab(line);
  int qi = find_col(header, kQuery);
  int ai = find_col(header, kArray);
  int ti = find_col(header, kType);
  int taui = find_col(header, kTau);
  if (taui < 0) taui = find_col(header, kRaw);
  int pi = find_col(header, kPval);
  if (qi < 0 || ai < 0 || taui < 0 || pi < 0) {
    res->error = "Kuzmin TSV is missing required columns";
    return res;
  }
  std::string want_type = mutant_type ? norm_col(mutant_type) : "";
  std::set<std::array<std::string, 3>> seen;

  int maxcol = std::max(std::max(qi, ai), std::max(taui, pi));
  if (ti >= 0) maxcol = std::max(maxcol, ti);
  while (std::getline(in, line)) {
    if (!line.empty() && line.back() == '\r') line.pop_back();
    auto rec = split_tab(line);
    if (static_cast<int>(rec.size()) <= maxcol) continue;
    if (ti >= 0 && !want_type.empty() && norm_col(rec[ti]) != want_type)
      continue;
    // Split query on '+': exactly two parts.
    const std::string& q = rec[qi];
    size_t plus = q.find('+');
    if (plus == std::string::npos || q.find('+', plus + 1) != std::string::npos)
      continue;
    std::string a = normalize_gene(q.substr(0, plus), strip_allele);
    std::string b = normalize_gene(q.substr(plus + 1), strip_allele);
    std::string c = normalize_gene(rec[ai], strip_allele);
    if (a.empty() || b.empty() || c.empty()) continue;
    double tau, pval;
    if (!parse_double(rec[taui], &tau) || !parse_double(rec[pi], &pval))
      continue;
    if (dedup) {
      std::array<std::string, 3> key = {a, b, c};
      std::sort(key.begin(), key.end());
      if (!seen.insert(key).second) continue;
    }
    int label = 0;
    if (pval < p_cutoff) {
      if (tau_mode_negative)
        label = tau < -tau_cutoff ? 1 : 0;
      else
        label = std::abs(tau) > tau_cutoff ? 1 : 0;
    }
    res->names += a;
    res->names += '\t';
    res->names += b;
    res->names += '\t';
    res->names += c;
    res->names += '\n';
    res->labels.push_back(label);
  }
  return res;
}

int64_t tip_result_n_rows(void* handle) {
  return static_cast<ParseResult*>(handle)->labels.size();
}

const char* tip_result_names(void* handle) {
  return static_cast<ParseResult*>(handle)->names.c_str();
}

const int32_t* tip_result_labels(void* handle) {
  auto* r = static_cast<ParseResult*>(handle);
  return r->labels.empty() ? nullptr : r->labels.data();
}

const char* tip_result_error(void* handle) {
  auto* r = static_cast<ParseResult*>(handle);
  return r->error.empty() ? nullptr : r->error.c_str();
}

void tip_free(void* handle) { delete static_cast<ParseResult*>(handle); }

}  // extern "C"
