// Native eventalign.txt parsing core and host helpers, with a plain C ABI
// for ctypes (no pybind11).  The port's copy of the JAX package's
// native/eventalign_parser.cpp: the same entry points and the same bytes out.
//
// dataprep:
//   ea_index                   streaming (contig, read_index) byte-range
//                              indexer -> eventalign.index
//   ea_load_index              eventalign.index -> first-appearance transcript
//                              codes + int64 columns, one pass
//   ea_combine_batch           parse + aggregate a transcript's read slices:
//                              filter reference_kmer == model_kmer,
//                              length-weighted mean/std/dwell per position
//                              (mean rounded to 1 decimal, position +2 center
//                              shift)
//   ea_featurize_batch         the above + DRACH-centred windows
//   ea_process_transcript(s)   a whole transcript (or a chunk of them):
//                              windows, site grouping, data.json lines;
//                              threaded over reads (M6A_NATIVE_THREADS)
// inference:
//   ea_parse_site_json         one data.json site line -> k-mer context +
//                              (rows, n_cols) float64 features
//   ea_render_indiv_csv_batch  a whole batch of data.indiv_proba.csv rows
//
// Numeric parity notes: accumulation in double in file order; the 1-decimal
// rounding uses rint (round-half-even) matching numpy.round.

#include <algorithm>
#include <charconv>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Field {
  const char* p;
  size_t len;
};

// Split a line into at most n_fields tab-separated fields (no copies).
static inline int split_fields(const char* line, const char* end, Field* out,
                               int n_fields) {
  int i = 0;
  const char* p = line;
  while (i < n_fields) {
    const char* tab = static_cast<const char*>(
        memchr(p, '\t', static_cast<size_t>(end - p)));
    if (tab == nullptr) {
      out[i].p = p;
      out[i].len = static_cast<size_t>(end - p);
      return i + 1;
    }
    out[i].p = p;
    out[i].len = static_cast<size_t>(tab - p);
    ++i;
    p = tab + 1;
  }
  return i;
}

static inline bool field_eq(const Field& a, const Field& b) {
  return a.len == b.len && memcmp(a.p, b.p, a.len) == 0;
}

// Strict field parsers: the WHOLE field must parse (no trailing junk, no
// leading '+', no out-of-range values) or the caller skips the line.  The
// Python fallback (dataprep/combine.py) enforces the identical policy so
// both paths accept/reject byte-for-byte the same lines
// (tests/test_native_fuzz.py asserts this on adversarial input).
static inline bool parse_double_strict(const Field& f, double* out) {
  // std::from_chars: no copy, no locale; identical rounding to strtod
  // (both correctly-rounded IEEE doubles); rejects '+', hex, partial fields.
  auto res = std::from_chars(f.p, f.p + f.len, *out);
  return res.ec == std::errc() && res.ptr == f.p + f.len;
}

static inline bool parse_ll_strict(const Field& f, long long* out) {
  auto res = std::from_chars(f.p, f.p + f.len, *out);
  return res.ec == std::errc() && res.ptr == f.p + f.len;
}

}  // namespace

extern "C" {

// Streaming byte-range indexer.  Writes the reference-compatible
// eventalign.index CSV.  Returns number of index rows, or -1 on error.
long long ea_index(const char* path, const char* out_path) {
  FILE* in = fopen(path, "rb");
  if (in == nullptr) return -1;
  FILE* out = fopen(out_path, "w");
  if (out == nullptr) {
    fclose(in);
    return -1;
  }
  fputs("transcript_id,read_index,pos_start,pos_end\n", out);

  const size_t CHUNK = 16u << 20;
  std::vector<char> buf(CHUNK);
  std::string leftover;
  std::string cur_contig, cur_read;
  long long pos = 0, cur_start = 0, rows = 0;
  bool have_cur = false, header_skipped = false;

  auto emit = [&](long long end_pos) {
    fprintf(out, "%s,%s,%lld,%lld\n", cur_contig.c_str(), cur_read.c_str(),
            cur_start, end_pos);
    ++rows;
  };

  for (;;) {
    size_t got = fread(buf.data(), 1, CHUNK, in);
    if (got == 0) break;
    size_t begin = 0;
    for (;;) {
      char* nl = static_cast<char*>(
          memchr(buf.data() + begin, '\n', got - begin));
      if (nl == nullptr) {
        leftover.append(buf.data() + begin, got - begin);
        break;
      }
      size_t line_end = static_cast<size_t>(nl - buf.data());
      const char* line;
      size_t line_len;
      std::string assembled;
      if (!leftover.empty()) {
        assembled.swap(leftover);
        assembled.append(buf.data() + begin, line_end - begin);
        line = assembled.data();
        line_len = assembled.size();
      } else {
        line = buf.data() + begin;
        line_len = line_end - begin;
      }
      long long nbytes = static_cast<long long>(line_len) + 1;
      if (!header_skipped) {
        header_skipped = true;
        pos += nbytes;
        cur_start = pos;
      } else {
        Field f[5];
        int nf = split_fields(line, line + line_len, f, 5);
        if (nf >= 4) {
          if (!have_cur || f[0].len != cur_contig.size() ||
              memcmp(f[0].p, cur_contig.data(), f[0].len) != 0 ||
              f[3].len != cur_read.size() ||
              memcmp(f[3].p, cur_read.data(), f[3].len) != 0) {
            if (have_cur) emit(pos);
            cur_contig.assign(f[0].p, f[0].len);
            cur_read.assign(f[3].p, f[3].len);
            cur_start = pos;
            have_cur = true;
          }
        }
        pos += nbytes;
      }
      begin = line_end + 1;
      if (begin >= got) break;
    }
    if (got < CHUNK) break;
  }
  if (!leftover.empty()) {
    fclose(in);
    fclose(out);
    return -2;  // file must end with newline
  }
  if (have_cur) emit(pos);
  fclose(in);
  fclose(out);
  return rows;
}

// Parse + aggregate a batch of read slices from one eventalign file.
//
// Inputs:  starts/ends — n byte ranges (one per read, header excluded)
// Outputs (caller-allocated, capacity cap):
//   out_pos   int64[cap]      center-shifted positions (sorted per read)
//   out_kmer  uint8[cap*5]    5-mer of each position
//   out_feat  double[cap*3]   (dwell_time, norm_std, norm_mean) per position
//   out_bounds int64[n+1]     prefix: positions per read
// Returns total positions written, or -1 on I/O error, -2 on overflow.
long long ea_combine_batch(const char* path, const int64_t* starts,
                           const int64_t* ends, int64_t n_reads,
                           int64_t* out_pos, uint8_t* out_kmer,
                           double* out_feat, int64_t* out_bounds,
                           int64_t cap) {
  FILE* in = fopen(path, "rb");
  if (in == nullptr) return -1;

  std::vector<char> buf;
  long long total = 0;
  out_bounds[0] = 0;

  struct Acc {
    long long pos;
    char kmer[5];
    double w_sum, mean_sum, std_sum, dwell_sum;
  };
  std::vector<Acc> accs;

  for (int64_t r = 0; r < n_reads; ++r) {
    int64_t len = ends[r] - starts[r];
    buf.resize(static_cast<size_t>(len));
    if (fseeko(in, starts[r], SEEK_SET) != 0 ||
        fread(buf.data(), 1, static_cast<size_t>(len), in) !=
            static_cast<size_t>(len)) {
      fclose(in);
      return -1;
    }
    accs.clear();

    const char* p = buf.data();
    const char* bend = buf.data() + len;
    while (p < bend) {
      const char* nl = static_cast<const char*>(
          memchr(p, '\n', static_cast<size_t>(bend - p)));
      const char* line_end = nl ? nl : bend;
      const char* next = line_end + 1;
      if (line_end > p && line_end[-1] == '\r') --line_end;  // tolerate \r\n
      Field f[15];
      int nf = split_fields(p, line_end, f, 15);
      p = next;
      if (nf < 15) continue;
      // reference_kmer (2) == model_kmer (9) filter
      if (!field_eq(f[2], f[9])) continue;
      long long position, s13, s14;
      double ev_mean, ev_stdv, ev_len;
      if (!parse_ll_strict(f[1], &position) ||
          !parse_double_strict(f[6], &ev_mean) ||
          !parse_double_strict(f[7], &ev_stdv) ||
          !parse_double_strict(f[8], &ev_len) ||
          !parse_ll_strict(f[13], &s13) || !parse_ll_strict(f[14], &s14)) {
        continue;  // malformed numeric field: skip the line
      }
      double w = static_cast<double>(s14 - s13);

      Acc* acc = nullptr;
      // positions arrive in order; check last accumulator first
      if (!accs.empty() && accs.back().pos == position) {
        acc = &accs.back();
      } else {
        for (auto it = accs.rbegin(); it != accs.rend(); ++it) {
          if (it->pos == position) {
            acc = &*it;
            break;
          }
        }
      }
      if (acc == nullptr) {
        accs.push_back(Acc{position, {0, 0, 0, 0, 0}, 0.0, 0.0, 0.0, 0.0});
        acc = &accs.back();
        memcpy(acc->kmer, f[2].p, f[2].len < 5 ? f[2].len : 5);
      }
      acc->w_sum += w;
      acc->mean_sum += ev_mean * w;
      acc->std_sum += ev_stdv * w;
      acc->dwell_sum += ev_len * w;
    }

    // sort by position (insertion order is nearly sorted; simple sort)
    std::sort(accs.begin(), accs.end(),
              [](const Acc& a, const Acc& b) { return a.pos < b.pos; });

    if (total + static_cast<long long>(accs.size()) > cap) {
      fclose(in);
      return -2;
    }
    for (const Acc& a : accs) {
      out_pos[total] = a.pos + 2;
      memcpy(out_kmer + total * 5, a.kmer, 5);
      out_feat[total * 3 + 0] = a.dwell_sum / a.w_sum;
      out_feat[total * 3 + 1] = a.std_sum / a.w_sum;
      out_feat[total * 3 + 2] = rint(a.mean_sum / a.w_sum * 10.0) / 10.0;
      ++total;
    }
    out_bounds[r + 1] = total;
  }
  fclose(in);
  return total;
}

}  // extern "C"

extern "C" {

// Fused parse + aggregate + window + DRACH-filter for a batch of read slices.
//
// For each read: aggregate events per position (as ea_combine_batch), then
// emit one window per position that (a) has `w` consecutive neighbours on
// both sides and (b) whose center 5-mer is in the DRACH motif set.
//
// Inputs:
//   motifs     n_motifs * 5 bytes (the DRACH center set)
//   w          neighbour radius (window = 2w+1 positions)
// Outputs (caller-allocated, capacity cap windows):
//   out_pos     int64[cap]            window center positions (+2 shifted)
//   out_seq     uint8[cap*(5+2w)]     combined sequence context
//   out_feat    double[cap*3*(2w+1)]  (dwell, std, mean) per window position
//   out_bounds  int64[n_reads+1]      window-count prefix per read
//   out_npos    int64[n_reads]        aggregated position count per read
// Returns total windows, or -1 on I/O error, -2 on overflow.
long long ea_featurize_batch(const char* path, const int64_t* starts,
                             const int64_t* ends, int64_t n_reads,
                             const uint8_t* motifs, int64_t n_motifs,
                             int64_t w, int64_t* out_pos, uint8_t* out_seq,
                             double* out_feat, int64_t* out_bounds,
                             int64_t* out_npos, int64_t cap) {
  FILE* in = fopen(path, "rb");
  if (in == nullptr) return -1;

  const int64_t width = 2 * w + 1;
  const int64_t seq_len = 5 + 2 * w;

  std::vector<char> buf;
  long long total = 0;
  out_bounds[0] = 0;

  struct Acc {
    long long pos;
    char kmer[5];
    double w_sum, mean_sum, std_sum, dwell_sum;
  };
  std::vector<Acc> accs;

  auto is_drach = [&](const char* k) {
    for (int64_t m = 0; m < n_motifs; ++m) {
      if (memcmp(k, motifs + m * 5, 5) == 0) return true;
    }
    return false;
  };

  for (int64_t r = 0; r < n_reads; ++r) {
    int64_t len = ends[r] - starts[r];
    buf.resize(static_cast<size_t>(len));
    if (fseeko(in, starts[r], SEEK_SET) != 0 ||
        fread(buf.data(), 1, static_cast<size_t>(len), in) !=
            static_cast<size_t>(len)) {
      fclose(in);
      return -1;
    }
    accs.clear();

    const char* p = buf.data();
    const char* bend = buf.data() + len;
    while (p < bend) {
      const char* nl = static_cast<const char*>(
          memchr(p, '\n', static_cast<size_t>(bend - p)));
      const char* line_end = nl ? nl : bend;
      const char* next = line_end + 1;
      if (line_end > p && line_end[-1] == '\r') --line_end;  // tolerate \r\n
      Field f[15];
      int nf = split_fields(p, line_end, f, 15);
      p = next;
      if (nf < 15) continue;
      if (!field_eq(f[2], f[9])) continue;
      long long position, s13, s14;
      double ev_mean, ev_stdv, ev_len;
      if (!parse_ll_strict(f[1], &position) ||
          !parse_double_strict(f[6], &ev_mean) ||
          !parse_double_strict(f[7], &ev_stdv) ||
          !parse_double_strict(f[8], &ev_len) ||
          !parse_ll_strict(f[13], &s13) || !parse_ll_strict(f[14], &s14)) {
        continue;  // malformed numeric field: skip the line
      }
      double wt = static_cast<double>(s14 - s13);

      Acc* acc = nullptr;
      if (!accs.empty() && accs.back().pos == position) {
        acc = &accs.back();
      } else {
        for (auto it = accs.rbegin(); it != accs.rend(); ++it) {
          if (it->pos == position) {
            acc = &*it;
            break;
          }
        }
      }
      if (acc == nullptr) {
        accs.push_back(Acc{position, {0, 0, 0, 0, 0}, 0.0, 0.0, 0.0, 0.0});
        acc = &accs.back();
        memcpy(acc->kmer, f[2].p, f[2].len < 5 ? f[2].len : 5);
      }
      acc->w_sum += wt;
      acc->mean_sum += ev_mean * wt;
      acc->std_sum += ev_stdv * wt;
      acc->dwell_sum += ev_len * wt;
    }

    std::sort(accs.begin(), accs.end(),
              [](const Acc& a, const Acc& b) { return a.pos < b.pos; });
    out_npos[r] = static_cast<int64_t>(accs.size());

    const int64_t n = static_cast<int64_t>(accs.size());
    for (int64_t i = w; i + w < n; ++i) {
      // consecutive span (positions are sorted unique)
      if (accs[i + w].pos - accs[i - w].pos != 2 * w) continue;
      if (!is_drach(accs[i].kmer)) continue;
      if (total >= cap) {
        fclose(in);
        return -2;
      }
      out_pos[total] = accs[i].pos + 2;
      uint8_t* seq = out_seq + total * seq_len;
      memcpy(seq, accs[i - w].kmer, 5);
      for (int64_t j = 1; j <= 2 * w; ++j) {
        seq[4 + j] = static_cast<uint8_t>(accs[i - w + j].kmer[4]);
      }
      double* feat = out_feat + total * 3 * width;
      for (int64_t j = 0; j < width; ++j) {
        const Acc& a = accs[i - w + j];
        feat[j * 3 + 0] = a.dwell_sum / a.w_sum;
        feat[j * 3 + 1] = a.std_sum / a.w_sum;
        feat[j * 3 + 2] = rint(a.mean_sum / a.w_sum * 10.0) / 10.0;
      }
      ++total;
    }
    out_bounds[r + 1] = total;
  }
  fclose(in);
  return total;
}

}  // extern "C"

#include <charconv>
#include <thread>
#include <unordered_map>

namespace {

// shortest-round-trip double -> chars (std::to_chars / Ryu), parse-equal to
// python repr output
static inline char* fmt_double(char* p, double v) {
  auto res = std::to_chars(p, p + 32, v);
  return res.ptr;
}

}  // namespace

extern "C" {

// Whole per-transcript featurization: parse + aggregate + window + DRACH
// filter + per-site grouping + (optional) data.json line rendering.
//
// Inputs:
//   tx_id, tx_len          transcript id string (for JSON rendering)
//   starts/ends/read_idx   n_reads byte ranges + read indices, in
//                          eventalign.index order (duplicate read_idx: last
//                          occurrence wins, reads with <2 aggregated
//                          positions are dropped)
//   motifs/n_motifs, w     DRACH set and neighbour radius
//   min_segment_count      minimum reads per emitted site
//   compress               round features to 3 decimals
//   emit_json              render data.json lines into json_out
// Outputs (caller-allocated):
//   site_pos   int64[cap_sites]
//   site_seq   uint8[cap_sites*(5+2w)]
//   site_nreads int64[cap_sites]
//   feat_out   double[cap_windows*3*(2w+1)]  site-major, read order preserved
//   read_out   int64[cap_windows]
//   json_out   char[json_cap]; json_len int64[cap_sites] per-site line length
// Returns number of sites, or -1 I/O error, -2 buffer overflow.
long long ea_process_transcript(
    const char* path, const char* tx_id, const int64_t* starts,
    const int64_t* ends, const int64_t* read_idx, int64_t n_reads,
    const uint8_t* motifs, int64_t n_motifs, int64_t w,
    int64_t min_segment_count, int32_t compress, int32_t emit_json,
    int64_t* site_pos, uint8_t* site_seq, int64_t* site_nreads,
    double* feat_out, int64_t* read_out, char* json_out, int64_t json_cap,
    int64_t* json_len, int64_t cap_sites, int64_t cap_windows) {
  const int64_t width = 2 * w + 1;
  const int64_t nfeat = 3 * width;
  const int64_t seq_len = 5 + 2 * w;

  // pass 1: fused featurize into scratch buffers, threaded over read ranges
  std::vector<int64_t> wpos(static_cast<size_t>(cap_windows));
  std::vector<uint8_t> wseq(static_cast<size_t>(cap_windows * seq_len));
  std::vector<double> wfeat(static_cast<size_t>(cap_windows * nfeat));
  std::vector<int64_t> wbounds(static_cast<size_t>(n_reads + 1));
  std::vector<int64_t> npos(static_cast<size_t>(n_reads));
  long long total;
  unsigned hw = std::thread::hardware_concurrency();
  int n_threads = static_cast<int>(hw ? hw : 1);
  if (const char* env = getenv("M6A_NATIVE_THREADS")) {
    int v = atoi(env);
    if (v >= 1) n_threads = v;
  }
  int64_t total_bytes = 0;
  for (int64_t r = 0; r < n_reads; ++r) total_bytes += ends[r] - starts[r];
  // Threads only pay off for substantial transcripts: spawning them per call
  // dominates on many-small-transcript inputs (thread start ~100us vs ~10us
  // of parsing per 2 KB read slice).
  if (n_threads > 1 && n_reads >= 2 * n_threads && total_bytes >= (4 << 20)) {
    // each thread featurizes a contiguous read range into private buffers
    struct Part {
      std::vector<int64_t> pos, bounds, npos;
      std::vector<uint8_t> seq;
      std::vector<double> feat;
      long long count = 0;
      int64_t r0 = 0, r1 = 0;
    };
    std::vector<Part> parts(static_cast<size_t>(n_threads));
    std::vector<std::thread> threads;
    int64_t per = (n_reads + n_threads - 1) / n_threads;
    for (int t = 0; t < n_threads; ++t) {
      Part& part = parts[static_cast<size_t>(t)];
      part.r0 = t * per;
      part.r1 = std::min<int64_t>(part.r0 + per, n_reads);
      if (part.r0 >= part.r1) { part.count = 0; continue; }
      int64_t nr = part.r1 - part.r0;
      int64_t cap = 0;
      for (int64_t r = part.r0; r < part.r1; ++r) cap += (ends[r] - starts[r]) / 30 + 2;
      part.pos.resize(static_cast<size_t>(cap));
      part.seq.resize(static_cast<size_t>(cap * seq_len));
      part.feat.resize(static_cast<size_t>(cap * nfeat));
      part.bounds.resize(static_cast<size_t>(nr + 1));
      part.npos.resize(static_cast<size_t>(nr));
      threads.emplace_back([&, t]() {
        Part& pp = parts[static_cast<size_t>(t)];
        pp.count = ea_featurize_batch(
            path, starts + pp.r0, ends + pp.r0, pp.r1 - pp.r0, motifs, n_motifs,
            w, pp.pos.data(), pp.seq.data(), pp.feat.data(), pp.bounds.data(),
            pp.npos.data(), static_cast<int64_t>(pp.pos.size()));
      });
    }
    for (auto& th : threads) th.join();
    total = 0;
    wbounds[0] = 0;
    for (int t = 0; t < n_threads; ++t) {
      Part& part = parts[static_cast<size_t>(t)];
      if (part.count < 0) return part.count;
      if (total + part.count > cap_windows) return -2;
      memcpy(wpos.data() + total, part.pos.data(),
             static_cast<size_t>(part.count) * sizeof(int64_t));
      memcpy(wseq.data() + total * seq_len, part.seq.data(),
             static_cast<size_t>(part.count * seq_len));
      memcpy(wfeat.data() + total * nfeat, part.feat.data(),
             static_cast<size_t>(part.count * nfeat) * sizeof(double));
      for (int64_t r = part.r0; r < part.r1; ++r) {
        wbounds[r + 1] = total + part.bounds[r - part.r0 + 1];
        npos[r] = part.npos[r - part.r0];
      }
      total += part.count;
    }
  } else {
    total = ea_featurize_batch(path, starts, ends, n_reads, motifs,
                               n_motifs, w, wpos.data(), wseq.data(),
                               wfeat.data(), wbounds.data(),
                               npos.data(), cap_windows);
  }
  if (total < 0) return total;

  // duplicate read_index: last occurrence wins
  std::unordered_map<int64_t, int64_t> last;
  last.reserve(static_cast<size_t>(n_reads) * 2);
  for (int64_t r = 0; r < n_reads; ++r) last[read_idx[r]] = r;

  // gather kept windows (read order preserved)
  std::vector<int64_t> kept;  // window indices
  std::vector<int64_t> kept_read;
  kept.reserve(static_cast<size_t>(total));
  kept_read.reserve(static_cast<size_t>(total));
  for (int64_t r = 0; r < n_reads; ++r) {
    if (npos[r] <= 1) continue;
    if (last[read_idx[r]] != r) continue;
    for (int64_t i = wbounds[r]; i < wbounds[r + 1]; ++i) {
      kept.push_back(i);
      kept_read.push_back(read_idx[r]);
    }
  }
  const int64_t n_kept = static_cast<int64_t>(kept.size());
  if (n_kept == 0) return 0;

  // stable sort window order by position (keeps read order within a site)
  std::vector<int64_t> order(static_cast<size_t>(n_kept));
  for (int64_t i = 0; i < n_kept; ++i) order[i] = i;
  std::stable_sort(order.begin(), order.end(), [&](int64_t a, int64_t b) {
    return wpos[kept[a]] < wpos[kept[b]];
  });

  const double round3 = 1000.0;
  long long n_sites = 0;
  int64_t cursor = 0;  // window rows emitted
  char* jp = json_out;
  char* jend = json_out + json_cap;

  int64_t i = 0;
  while (i < n_kept) {
    int64_t j = i;
    const int64_t pos = wpos[kept[order[i]]];
    while (j < n_kept && wpos[kept[order[j]]] == pos) ++j;
    const int64_t cnt = j - i;
    if (cnt < min_segment_count) {
      i = j;
      continue;
    }
    if (n_sites >= cap_sites || cursor + cnt > cap_windows) return -2;

    const uint8_t* seq = wseq.data() + kept[order[i]] * seq_len;
    site_pos[n_sites] = pos;
    memcpy(site_seq + n_sites * seq_len, seq, static_cast<size_t>(seq_len));
    site_nreads[n_sites] = cnt;

    char* line_start = jp;
    if (emit_json) {
      if (jend - jp < 64 + seq_len) return -2;
      jp += snprintf(jp, static_cast<size_t>(jend - jp), "{\"%s\":{\"%lld\":{\"%.*s\":[",
                     tx_id, static_cast<long long>(pos),
                     static_cast<int>(seq_len), reinterpret_cast<const char*>(seq));
    }
    for (int64_t k = i; k < j; ++k) {
      const int64_t win = kept[order[k]];
      const double* src = wfeat.data() + win * nfeat;
      double* dst = feat_out + cursor * nfeat;
      for (int64_t c = 0; c < nfeat; ++c) {
        double v = src[c];
        if (compress) v = rint(v * round3) / round3;
        dst[c] = v;
      }
      read_out[cursor] = kept_read[order[k]];
      if (emit_json) {
        if (jend - jp < 32 * (nfeat + 2) + 8) return -2;
        *jp++ = '[';
        for (int64_t c = 0; c < nfeat; ++c) {
          jp = fmt_double(jp, dst[c]);
          *jp++ = ',';
        }
        // read id serialised as float for reference parity ("123.0");
        // formatted as integer text to stay exact beyond 2^53
        jp += snprintf(jp, 32, "%lld.0", static_cast<long long>(kept_read[order[k]]));
        *jp++ = ']';
        if (k + 1 < j) *jp++ = ',';
      }
      ++cursor;
    }
    if (emit_json) {
      if (jend - jp < 8) return -2;
      memcpy(jp, "]}}}\n", 5);
      jp += 5;
      json_len[n_sites] = static_cast<int64_t>(jp - line_start);
    }
    ++n_sites;
    i = j;
  }
  return n_sites;
}

// Batched form: process n_tx transcripts in one call (the per-call Python /
// ctypes crossing dominates on many-small-transcript inputs).  Outputs are
// the single-transcript layouts concatenated in transcript order, with
// tx_site_counts giving each transcript's site count.
//   tx_names/tx_name_off   concatenated ids + n_tx+1 offsets
//   tx_bounds              n_tx+1 prefix into the read arrays
// Returns total sites, or -1 I/O error, -2 buffer overflow.
long long ea_process_transcripts(
    const char* path, const char* tx_names, const int64_t* tx_name_off,
    const int64_t* tx_bounds, const int64_t* starts, const int64_t* ends,
    const int64_t* read_idx, int64_t n_tx, const uint8_t* motifs,
    int64_t n_motifs, int64_t w, int64_t min_segment_count, int32_t compress,
    int32_t emit_json, int64_t* tx_site_counts, int64_t* site_pos,
    uint8_t* site_seq, int64_t* site_nreads, double* feat_out,
    int64_t* read_out, char* json_out, int64_t json_cap, int64_t* json_len,
    int64_t cap_sites, int64_t cap_windows) {
  const int64_t seq_len = 5 + 2 * w;
  const int64_t nfeat = 3 * (2 * w + 1);
  int64_t site_cur = 0, window_cur = 0, json_cur = 0;
  std::string name;
  for (int64_t t = 0; t < n_tx; ++t) {
    const int64_t b0 = tx_bounds[t], b1 = tx_bounds[t + 1];
    const int64_t n_reads = b1 - b0;
    name.assign(tx_names + tx_name_off[t],
                static_cast<size_t>(tx_name_off[t + 1] - tx_name_off[t]));
    // per-transcript caps: bound the scratch allocations inside the single-
    // transcript routine by this transcript's own size, not the whole chunk
    int64_t tx_bytes = 0;
    for (int64_t r = b0; r < b1; ++r) tx_bytes += ends[r] - starts[r];
    const int64_t est = tx_bytes / 30 + n_reads + 16;
    const int64_t cap_w = std::min(est, cap_windows - window_cur);
    const int64_t cap_s = std::min(est + 1, cap_sites - site_cur);
    if (cap_w <= 0 || cap_s <= 0) return -2;
    long long ns = ea_process_transcript(
        path, name.c_str(), starts + b0, ends + b0, read_idx + b0, n_reads,
        motifs, n_motifs, w, min_segment_count, compress, emit_json,
        site_pos + site_cur, site_seq + site_cur * seq_len,
        site_nreads + site_cur, feat_out + window_cur * nfeat,
        read_out + window_cur, json_out + json_cur, json_cap - json_cur,
        json_len + site_cur, cap_s, cap_w);
    if (ns < 0) return ns;
    tx_site_counts[t] = ns;
    for (long long s = 0; s < ns; ++s) {
      window_cur += site_nreads[site_cur + s];
      if (emit_json) json_cur += json_len[site_cur + s];
    }
    site_cur += ns;
  }
  return site_cur;
}

}  // extern "C"

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

}  // extern "C"

extern "C" {

// Parse eventalign.index (header + 4 CSV columns) in one pass.
// Transcript ids are deduplicated to first-appearance codes so the caller
// never materialises per-row strings:
//   codes     int32[n_rows]   transcript code per row
//   read_idx/pos_start/pos_end  int64[n_rows]
//   name_buf  char[name_cap]  unique names, '\n'-separated, appearance order
// Returns n_rows (writes [n_uniq, name_bytes] via out_n_uniq), -1 on I/O
// error, -2 on overflow of caller buffers.
long long ea_load_index(const char* path, int32_t* codes, int64_t* read_idx,
                        int64_t* pos_start, int64_t* pos_end,
                        int64_t cap_rows, char* name_buf, int64_t name_cap,
                        int64_t* out_n_uniq) {
  FILE* in = fopen(path, "rb");
  if (in == nullptr) return -1;
  fseeko(in, 0, SEEK_END);
  int64_t fsize = ftello(in);
  fseeko(in, 0, SEEK_SET);
  std::vector<char> buf(static_cast<size_t>(fsize));
  if (fread(buf.data(), 1, static_cast<size_t>(fsize), in) !=
      static_cast<size_t>(fsize)) {
    fclose(in);
    return -1;
  }
  fclose(in);

  struct SvHash {
    size_t operator()(const std::pair<const char*, size_t>& s) const {
      size_t h = 1469598103934665603ull;
      for (size_t i = 0; i < s.second; ++i) {
        h ^= static_cast<unsigned char>(s.first[i]);
        h *= 1099511628211ull;
      }
      return h;
    }
  };
  struct SvEq {
    bool operator()(const std::pair<const char*, size_t>& a,
                    const std::pair<const char*, size_t>& b) const {
      return a.second == b.second && memcmp(a.first, b.first, a.second) == 0;
    }
  };
  std::unordered_map<std::pair<const char*, size_t>, int32_t, SvHash, SvEq> ids;

  const char* p = buf.data();
  const char* end = buf.data() + fsize;
  // skip header
  const char* nl = static_cast<const char*>(memchr(p, '\n', fsize));
  if (nl == nullptr) return -1;
  p = nl + 1;

  long long rows = 0;
  char* np = name_buf;
  char* nend = name_buf + name_cap;
  int32_t n_uniq = 0;
  const char* last_key_p = nullptr;
  size_t last_key_len = 0;
  int32_t last_code = -1;
  while (p < end) {
    nl = static_cast<const char*>(memchr(p, '\n', static_cast<size_t>(end - p)));
    const char* next = (nl ? nl : end) + 1;
    const char* line_end = nl ? nl : end;
    if (line_end > p && line_end[-1] == '\r') --line_end;  // CRLF tolerance
    if (line_end == p) { p = next; continue; }
    if (rows >= cap_rows) return -2;
    const char* c1 = static_cast<const char*>(memchr(p, ',', static_cast<size_t>(line_end - p)));
    if (c1 == nullptr) return -1;
    const size_t key_len = static_cast<size_t>(c1 - p);
    int32_t code;
    // rows are grouped by transcript: the previous row's key almost always
    // repeats, so skip the hash lookup for it
    if (last_key_p != nullptr && key_len == last_key_len &&
        memcmp(p, last_key_p, key_len) == 0) {
      code = last_code;
    } else {
      auto key = std::make_pair(p, key_len);
      auto it = ids.find(key);
      if (it == ids.end()) {
        if (nend - np < static_cast<int64_t>(key_len) + 1) return -2;
        memcpy(np, p, key_len);
        np += key_len;
        *np++ = '\n';
        it = ids.emplace(key, n_uniq++).first;
      }
      code = it->second;
      last_key_p = it->first.first;
      last_key_len = key_len;
      last_code = code;
    }
    codes[rows] = code;
    // strict digit parsing: any non-digit (other than the ',' delimiter)
    // aborts instead of silently corrupting byte offsets
    const char* q = c1 + 1;
    long long v = 0;
    for (; q < line_end && *q != ','; ++q) {
      if (*q < '0' || *q > '9') return -1;
      v = v * 10 + (*q - '0');
    }
    if (q >= line_end) return -1;
    read_idx[rows] = v;
    v = 0;
    for (++q; q < line_end && *q != ','; ++q) {
      if (*q < '0' || *q > '9') return -1;
      v = v * 10 + (*q - '0');
    }
    if (q >= line_end) return -1;
    pos_start[rows] = v;
    v = 0;
    for (++q; q < line_end; ++q) {
      if (*q < '0' || *q > '9') return -1;
      v = v * 10 + (*q - '0');
    }
    pos_end[rows] = v;
    ++rows;
    p = next;
  }
  out_n_uniq[0] = n_uniq;
  out_n_uniq[1] = static_cast<int64_t>(np - name_buf);
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
