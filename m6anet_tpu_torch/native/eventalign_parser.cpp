// Native host helpers of the inference path, with a plain C ABI for ctypes.
//
//   ea_parse_site_json         one data.json site line -> k-mer context +
//                              (rows, n_cols) float64 features
//   ea_render_indiv_csv_batch  a whole batch of data.indiv_proba.csv rows
//
// The port's copy of the two inference entry points of the JAX package's
// native/eventalign_parser.cpp; the dataprep parsers stay there.

#include <charconv>
#include <cstdint>
#include <cstdlib>
#include <cstring>

extern "C" {

// Specialised parser for one data.json site line:
//   {"<tx>":{"<pos>":{"<kmer>":[[f,f,...,f],[...],...]}}}
// Fills out_feat (row-major, n_cols per row) and returns the row count;
// writes the k-mer context into out_kmer (<= 32 bytes, NUL-terminated).
// Returns -1 on malformed input, -2 on overflow.
long long ea_parse_site_json(const char* buf, int64_t len, double* out_feat,
                             int64_t cap_rows, int64_t n_cols,
                             char* out_kmer, int64_t kmer_cap) {
  const char* p = buf;
  const char* end = buf + len;
  // third '"'-quoted string is the kmer: skip tx and pos keys
  int quotes = 0;
  const char* kstart = nullptr;
  while (p < end) {
    if (*p == '"') {
      ++quotes;
      if (quotes == 5) {  // opening quote of the kmer key
        kstart = p + 1;
      } else if (quotes == 6) {
        int64_t klen = p - kstart;
        if (klen >= kmer_cap) return -1;
        memcpy(out_kmer, kstart, static_cast<size_t>(klen));
        out_kmer[klen] = '\0';
        ++p;
        break;
      }
    }
    ++p;
  }
  if (kstart == nullptr) return -1;
  // advance to the first '[' of the array-of-arrays
  while (p < end && *p != '[') ++p;
  if (p >= end) return -1;
  ++p;  // inside outer array

  long long rows = 0;
  while (p < end) {
    while (p < end && (*p == ',' || *p == ' ')) ++p;
    if (p >= end || *p == ']') break;  // outer array closed
    if (*p != '[') return -1;
    ++p;
    if (rows >= cap_rows) return -2;
    double* row = out_feat + rows * n_cols;
    for (int64_t c = 0; c < n_cols; ++c) {
      while (p < end && (*p == ',' || *p == ' ')) ++p;
      char* next = nullptr;
      row[c] = strtod(p, &next);
      if (next == p) return -1;
      p = next;
    }
    while (p < end && *p != ']') ++p;
    if (p >= end) return -1;
    ++p;  // close row
    ++rows;
  }
  return rows;
}

// Render a whole batch of sites' indiv_proba CSV rows in one call:
// for site i, for each of its site_counts[i] reads:
//   "<prefix_i><read_id>,<prob .16 fixed>\n"
// prefixes = concatenated per-site prefixes, prefix_off = n_sites+1 offsets.
// Values use std::to_chars(fixed, 16) — identical digits to printf %.16f
// (both correctly rounded). Returns bytes written, or -2 on overflow.
long long ea_render_indiv_csv_batch(const char* prefixes,
                                    const int64_t* prefix_off,
                                    const int64_t* site_counts,
                                    int64_t n_sites, const int64_t* read_ids,
                                    const float* probs, char* out,
                                    int64_t cap) {
  char* p = out;
  char* end = out + cap;
  int64_t row = 0;
  for (int64_t i = 0; i < n_sites; ++i) {
    const char* pre = prefixes + prefix_off[i];
    const int64_t pre_len = prefix_off[i + 1] - prefix_off[i];
    for (int64_t j = 0; j < site_counts[i]; ++j, ++row) {
      if (end - p < pre_len + 64) return -2;
      memcpy(p, pre, static_cast<size_t>(pre_len));
      p += pre_len;
      p = std::to_chars(p, end, static_cast<long long>(read_ids[row])).ptr;
      *p++ = ',';
      p = std::to_chars(p, end, static_cast<double>(probs[row]),
                        std::chars_format::fixed, 16)
              .ptr;
      *p++ = '\n';
    }
  }
  return static_cast<long long>(p - out);
}

}  // extern "C"
