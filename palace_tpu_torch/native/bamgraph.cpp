// palace_native — BAM streaming runtime of the PALACE host stages.
//
// Subcommands:
//   palace_native graph <bam> <fastg_fai> <out_graph> <avg_depth>
//                       [max_span_frac min_count]
//   palace_native depth <bam> <out_depth_txt>
//
// Re-implements the junction-graph construction of the reference's
// bin/generate_graph.cpp (htslib) and the depth pass of `samtools depth`
// with a self-contained BGZF/BAM decoder (zlib only).  The semantics are
// kept bit-identical to palace_tpu_torch/graph/builder.py, the Python
// builder this binary is tested against (tests/test_torch_graph.py).
// Built with g++ at first use by palace_tpu_torch/native/_build.py.
//
// References to the upstream file:line are semantic citations, not
// copied code.

#include <zlib.h>

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <fstream>
#include <iostream>
#include <map>
#include <set>
#include <sstream>
#include <string>
#include <unordered_map>
#include <unordered_set>
#include <vector>

// ---------------------------------------------------------------------------
// BGZF reader
// ---------------------------------------------------------------------------

class BgzfReader {
 public:
  explicit BgzfReader(const std::string& path) : in_(path, std::ios::binary) {}
  bool ok() const { return in_.good(); }

  // Read exactly n bytes of decompressed payload; false at clean EOF.
  bool read(void* dst, size_t n) {
    char* out = static_cast<char*>(dst);
    while (n > 0) {
      if (pos_ == buf_.size()) {
        if (!next_block()) return false;
        if (buf_.empty()) continue;
      }
      size_t take = std::min(n, buf_.size() - pos_);
      memcpy(out, buf_.data() + pos_, take);
      pos_ += take;
      out += take;
      n -= take;
    }
    return true;
  }

  bool eof() {
    if (pos_ < buf_.size()) return false;
    while (next_block()) {
      if (!buf_.empty()) return false;
    }
    return true;
  }

 private:
  bool next_block() {
    unsigned char hdr[18];
    in_.read(reinterpret_cast<char*>(hdr), 18);
    if (in_.gcount() == 0) return false;
    if (in_.gcount() < 18 || hdr[0] != 31 || hdr[1] != 139) {
      fprintf(stderr, "bgzf: bad block header\n");
      return false;
    }
    uint16_t xlen = hdr[10] | (hdr[11] << 8);
    // find BC subfield for BSIZE; we already consumed 6 of xlen
    uint16_t bsize = 0;
    if (hdr[12] == 'B' && hdr[13] == 'C') {
      bsize = hdr[16] | (hdr[17] << 8);
      if (xlen > 6) in_.ignore(xlen - 6);
    } else {
      // scan the extra field
      std::vector<unsigned char> extra(xlen);
      memcpy(extra.data(), hdr + 12, 6);
      in_.read(reinterpret_cast<char*>(extra.data() + 6), xlen - 6);
      for (size_t i = 0; i + 4 <= extra.size();) {
        uint16_t slen = extra[i + 2] | (extra[i + 3] << 8);
        if (extra[i] == 'B' && extra[i + 1] == 'C' && slen == 2) {
          bsize = extra[i + 4] | (extra[i + 5] << 8);
          break;
        }
        i += 4 + slen;
      }
    }
    if (bsize == 0) {
      fprintf(stderr, "bgzf: missing BSIZE\n");
      return false;
    }
    size_t cdata_len = bsize + 1 - 18 - 8;
    cbuf_.resize(cdata_len);
    in_.read(reinterpret_cast<char*>(cbuf_.data()), cdata_len);
    unsigned char tail[8];
    in_.read(reinterpret_cast<char*>(tail), 8);
    uint32_t isize = tail[4] | (tail[5] << 8) | (tail[6] << 16) |
                     (uint32_t(tail[7]) << 24);
    buf_.resize(isize);
    pos_ = 0;
    if (isize == 0) return true;
    z_stream zs{};
    inflateInit2(&zs, -15);
    zs.next_in = cbuf_.data();
    zs.avail_in = cdata_len;
    zs.next_out = buf_.data();
    zs.avail_out = isize;
    int rc = inflate(&zs, Z_FINISH);
    inflateEnd(&zs);
    if (rc != Z_STREAM_END) {
      fprintf(stderr, "bgzf: inflate failed (%d)\n", rc);
      return false;
    }
    return true;
  }

  std::ifstream in_;
  std::vector<unsigned char> cbuf_;
  std::vector<unsigned char> buf_;
  size_t pos_ = 0;
};

// ---------------------------------------------------------------------------
// BAM structures
// ---------------------------------------------------------------------------

static const char* CIGAR_OPS = "MIDNSHP=X";

struct BamRec {
  int32_t tid = -1, pos = 0, mtid = -1, mpos = 0;
  uint16_t flag = 0;
  uint8_t mapq = 0;
  std::string name;
  std::vector<uint32_t> cigar;  // len<<4 | op
  int nm = 0;
  bool has_sa = false;
  std::string sa;
};

struct BamHeader {
  std::vector<std::string> names;
  std::vector<int32_t> lens;
  std::unordered_map<std::string, int> tid;
};

static bool read_header(BgzfReader& r, BamHeader& h) {
  char magic[4];
  if (!r.read(magic, 4) || memcmp(magic, "BAM\1", 4) != 0) return false;
  int32_t l_text;
  r.read(&l_text, 4);
  std::vector<char> text(l_text);
  if (l_text) r.read(text.data(), l_text);
  int32_t n_ref;
  r.read(&n_ref, 4);
  for (int i = 0; i < n_ref; i++) {
    int32_t l_name, l_ref;
    r.read(&l_name, 4);
    std::string name(l_name, '\0');
    r.read(&name[0], l_name);
    name.resize(l_name - 1);
    r.read(&l_ref, 4);
    h.names.push_back(name);
    h.lens.push_back(l_ref);
    h.tid[name] = i;
  }
  return true;
}

static bool read_record(BgzfReader& r, BamRec& rec) {
  int32_t block_size;
  if (r.eof()) return false;
  if (!r.read(&block_size, 4)) return false;
  std::vector<unsigned char> buf(block_size);
  if (!r.read(buf.data(), block_size)) return false;
  const unsigned char* p = buf.data();
  auto rd_i32 = [&](size_t off) {
    int32_t v;
    memcpy(&v, p + off, 4);
    return v;
  };
  rec.tid = rd_i32(0);
  rec.pos = rd_i32(4);
  uint8_t l_read_name = p[8];
  rec.mapq = p[9];
  uint16_t n_cigar;
  memcpy(&n_cigar, p + 12, 2);
  memcpy(&rec.flag, p + 14, 2);
  int32_t l_seq = rd_i32(16);
  rec.mtid = rd_i32(20);
  rec.mpos = rd_i32(24);
  size_t off = 32;
  rec.name.assign(reinterpret_cast<const char*>(p + off), l_read_name - 1);
  off += l_read_name;
  rec.cigar.assign(n_cigar, 0);
  memcpy(rec.cigar.data(), p + off, 4ull * n_cigar);
  off += 4ull * n_cigar;
  off += (l_seq + 1) / 2 + l_seq;
  // aux
  rec.nm = 0;
  rec.has_sa = false;
  rec.sa.clear();
  size_t n = buf.size();
  while (off + 3 <= n) {
    char t0 = p[off], t1 = p[off + 1], typ = p[off + 2];
    off += 3;
    size_t adv = 0;
    switch (typ) {
      case 'A': case 'c': case 'C': adv = 1; break;
      case 's': case 'S': adv = 2; break;
      case 'i': case 'I': case 'f': adv = 4; break;
      case 'Z': case 'H': {
        size_t end = off;
        while (end < n && p[end] != 0) end++;
        if (t0 == 'S' && t1 == 'A') {
          rec.has_sa = true;
          rec.sa.assign(reinterpret_cast<const char*>(p + off), end - off);
        }
        off = end + 1;
        continue;
      }
      case 'B': {
        char sub = p[off];
        uint32_t cnt;
        memcpy(&cnt, p + off + 1, 4);
        size_t esize = (sub == 'c' || sub == 'C') ? 1 : (sub == 's' || sub == 'S') ? 2 : 4;
        off += 5 + cnt * esize;
        continue;
      }
      default:
        return true;  // unknown tag type: stop parsing aux
    }
    if (t0 == 'N' && t1 == 'M') {
      int64_t v = 0;
      switch (typ) {
        case 'c': v = *reinterpret_cast<const int8_t*>(p + off); break;
        case 'C': v = p[off]; break;
        case 's': { int16_t x; memcpy(&x, p + off, 2); v = x; break; }
        case 'S': { uint16_t x; memcpy(&x, p + off, 2); v = x; break; }
        case 'i': { int32_t x; memcpy(&x, p + off, 4); v = x; break; }
        case 'I': { uint32_t x; memcpy(&x, p + off, 4); v = x; break; }
        default: break;
      }
      rec.nm = (int)v;
    }
    off += adv;
  }
  return true;
}

static int cigar_ref_len(const std::vector<uint32_t>& cig) {
  int total = 0;
  for (uint32_t c : cig) {
    char op = CIGAR_OPS[c & 0xF];
    if (op == 'M' || op == '=' || op == 'X' || op == 'D' || op == 'N')
      total += c >> 4;
  }
  return total;
}

static int cigar_read_len(const std::vector<uint32_t>& cig) {
  int total = 0;
  for (uint32_t c : cig) {
    char op = CIGAR_OPS[c & 0xF];
    if (op == 'M' || op == 'I' || op == 'S' || op == '=' || op == 'X')
      total += c >> 4;
  }
  return total;
}

// ---------------------------------------------------------------------------
// graph semantics (mirrors palace_tpu_torch/graph/builder.py, which mirrors
// reference generate_graph.cpp — see the Python file for the quirk notes)
// ---------------------------------------------------------------------------

namespace graphsem {

constexpr int START = 0, END = 1, MIDDLE = 2;

struct Params {
  int max_end = 300;
  int min_mapq = 0;
  int max_nm = 5;
  double max_span_frac = 0.80;
  int min_count = 5;
  bool enable_paired = true;
  int max_gap = 150;
  int max_overlap = 150;
};

static int contig_region(int pos1, int len, int max_end) {
  int pref = std::min(max_end, len / 2);
  int suff = std::max(len - max_end, len / 2);
  if (pos1 <= pref) return START;
  if (pos1 > suff) return END;
  return MIDDLE;
}

static int flip_region(int r) { return r == START ? END : (r == END ? START : MIDDLE); }
static int dist_to_start(int pos) { return std::max(0, pos - 1); }
static int dist_to_end(int pos, int L) { return std::max(0, L - pos); }

struct Interval {
  int start = 0, end = 0;
};

struct CigOps {
  std::vector<std::pair<int, char>> ops;
};

static CigOps parse_cigar_str(const std::string& s) {
  CigOps out;
  int n = 0;
  for (char c : s) {
    if (c >= '0' && c <= '9') {
      n = n * 10 + (c - '0');
    } else {
      if (n > 0) out.ops.push_back({n, c});
      n = 0;
    }
  }
  return out;
}

static Interval read_interval(const std::vector<std::pair<int, char>>& ops,
                              bool is_rev, int read_len) {
  Interval iv;
  if (ops.empty()) return iv;
  int soft_start = (ops.front().second == 'S') ? ops.front().first : 0;
  int soft_end = (ops.size() > 1 && ops.back().second == 'S') ? ops.back().first : 0;
  int consumed = 0;
  for (auto& o : ops) {
    char c = o.second;
    if (c == 'M' || c == 'I' || c == 'S' || c == '=' || c == 'X') consumed += o.first;
  }
  if (!is_rev) {
    iv.start = soft_start + 1;
    iv.end = consumed - soft_end;
  } else if (read_len > 0) {
    iv.start = read_len - (consumed - soft_end) + 1;
    iv.end = read_len - soft_start;
  } else {
    iv.start = soft_start + 1;
    iv.end = consumed - soft_end;
  }
  return iv;
}

// returns -1 (no), 1 (first1=true), 0 (first1=false)
static int can_stitch(const Interval& a, const Interval& b, int max_gap, int max_overlap) {
  if (a.end <= b.start && b.start - a.end - 1 <= max_gap) return 1;
  if (b.end <= a.start && a.start - b.end - 1 <= max_gap) return 0;
  if (a.start <= b.end && b.start <= a.end) {
    int overlap = std::min(a.end, b.end) - std::max(a.start, b.start) + 1;
    if (overlap <= max_overlap) return a.start <= b.start ? 1 : 0;
  }
  return -1;
}

static double end_weight(int d1, int d2, int max_end) {
  double lam = std::max(50.0, max_end / 2.0);
  return std::exp(-(double)d1 / lam) * std::exp(-(double)d2 / lam);
}

struct Evidence {
  int LA = 0, LB = 0, posA = 0, posB = 0, regA = MIDDLE, regB = MIDDLE;
  int mapqA = 0, nmA = 0, mapqB = 0, nmB = 0;
};

static double layout_score(const Evidence& ev, bool left_is_a, char oL, char oR,
                           int max_end) {
  int LL = left_is_a ? ev.LA : ev.LB, LR = left_is_a ? ev.LB : ev.LA;
  int posL = left_is_a ? ev.posA : ev.posB, posR = left_is_a ? ev.posB : ev.posA;
  int regL = left_is_a ? ev.regA : ev.regB, regR = left_is_a ? ev.regB : ev.regA;
  int mapqL = left_is_a ? ev.mapqA : ev.mapqB, nmL = left_is_a ? ev.nmA : ev.nmB;
  int mapqR = left_is_a ? ev.mapqB : ev.mapqA, nmR = left_is_a ? ev.nmB : ev.nmA;
  int gL = (oL == '-') ? flip_region(regL) : regL;
  int gR = (oR == '-') ? flip_region(regR) : regR;
  int dL = (gL == START) ? dist_to_start(posL) : dist_to_end(posL, LL);
  int dR = (gR == START) ? dist_to_start(posR) : dist_to_end(posR, LR);
  double w_end = end_weight(dL, dR, max_end);
  double w_l = std::min(1.0, (double)mapqL / 60.0) * (1.0 / (1.0 + 0.2 * std::max(0, nmL)));
  double w_r = std::min(1.0, (double)mapqR / 60.0) * (1.0 / (1.0 + 0.2 * std::max(0, nmR)));
  return w_end * w_l * w_r;
}

static bool split_layout(bool rev1, int reg1, bool rev2, int reg2, char oL, char oR,
                         bool first1) {
  bool revL = first1 ? rev1 : rev2, revR = first1 ? rev2 : rev1;
  int regL = first1 ? reg1 : reg2, regR = first1 ? reg2 : reg1;
  bool fwdL = (oL == '-') ? revL : !revL;
  bool fwdR = (oR == '-') ? revR : !revR;
  if (!fwdL || !fwdR) return false;
  if (regL == MIDDLE || regR == MIDDLE) return false;
  if (regL != ((oL == '+') ? END : START)) return false;
  if (regR != ((oR == '+') ? START : END)) return false;
  return true;
}

static bool paired_layout(int pos1, bool rev1, int reg1, int L1, int pos2, bool rev2,
                          int reg2, int L2, char oL, char oR, bool first1,
                          double max_span_frac) {
  bool revL, revR;
  int regL, regR, posL, posR, LL, LR;
  if (first1) {
    revL = rev1; revR = rev2; regL = reg1; regR = reg2;
    posL = pos1; posR = pos2; LL = L1; LR = L2;
  } else {
    revL = rev2; revR = rev1; regL = reg2; regR = reg1;
    posL = pos2; posR = pos1; LL = L2; LR = L1;
  }
  bool fwdL = (oL == '-') ? revL : !revL;
  bool fwdR = (oR == '-') ? revR : !revR;
  if (!fwdL || fwdR) return false;
  if (regL == MIDDLE || regR == MIDDLE) return false;
  if (regL != ((oL == '+') ? END : START)) return false;
  if (regR != ((oR == '+') ? START : END)) return false;
  int distL = (regL == START) ? dist_to_start(posL) : dist_to_end(posL, LL);
  int distR = (regR == START) ? dist_to_start(posR) : dist_to_end(posR, LR);
  double fracL = LL > 0 ? (double)distL / LL : 1.0;
  double fracR = LR > 0 ? (double)distR / LR : 1.0;
  if (fracL > max_span_frac || fracR > max_span_frac) return false;
  return true;
}

struct OrientedPair {
  std::string a, b;
  char oa, ob;
  bool operator<(const OrientedPair& o) const {
    if (a != o.a) return a < o.a;
    if (b != o.b) return b < o.b;
    if (oa != o.oa) return oa < o.oa;
    return ob < o.ob;
  }
};

// fastg fai → expected oriented pairs (reference parseFastgFile :119-169,
// including the positional-flip quirk)
static std::set<OrientedPair> parse_fastg_pairs(const std::string& path) {
  std::set<OrientedPair> pairs;
  std::ifstream in(path);
  std::string line;
  while (std::getline(in, line)) {
    std::string first = line.substr(0, line.find('\t'));
    std::string full = first.substr(0, first.find(';'));
    size_t colon = full.find(':');
    std::string head = full.substr(0, colon);
    bool head_rev = !head.empty() && head.back() == '\'';
    if (head_rev) head.pop_back();
    if (colon == std::string::npos) continue;
    std::stringstream rest(full.substr(colon + 1));
    std::string item;
    while (std::getline(rest, item, ',')) {
      if (item.empty()) continue;
      bool rev = item.back() == '\'';
      if (rev) item.pop_back();
      char o1, o2;
      if (!head_rev) {
        o1 = '+';
        o2 = rev ? '-' : '+';
      } else {
        o1 = '-';
        o2 = rev ? '+' : '-';
      }
      pairs.insert({head, item, o1, o2});
      pairs.insert({item, head, o1 == '+' ? '-' : '+', o2 == '+' ? '-' : '+'});
    }
  }
  return pairs;
}

struct Agg {
  int supplement = 0, span = 0, supplement_no_fastg = 0, span_no_fastg = 0;
};

struct SaItem {
  std::string rname;
  int pos = 0;
  bool is_rev = false;
  std::string cigar;
  int mapq = 0, nm = 0;
  bool ok = false;
};

static SaItem parse_sa(const std::string& item) {
  SaItem it;
  std::vector<std::string> f;
  std::stringstream ss(item);
  std::string tok;
  while (std::getline(ss, tok, ',')) {
    // trim
    size_t b = tok.find_first_not_of(" \t");
    size_t e = tok.find_last_not_of(" \t");
    f.push_back(b == std::string::npos ? "" : tok.substr(b, e - b + 1));
  }
  if (f.size() < 6 || f[0].empty() || f[1].empty()) return it;
  it.rname = f[0];
  it.pos = atoi(f[1].c_str());
  it.is_rev = f[2] == "-";
  it.cigar = f[3];
  it.mapq = atoi(f[4].c_str());
  it.nm = atoi(f[5].c_str());
  it.ok = true;
  return it;
}

static void fmt_num(std::ostream& os, double x) {
  // default C++ ostream double formatting (6 significant digits)
  std::ostringstream ss;
  ss << x;
  os << ss.str();
}

int run_graph(const std::string& bam_path, const std::string& fastg_fai,
              const std::string& out_path, double avg_depth, const Params& P) {
  auto fastg_pairs = parse_fastg_pairs(fastg_fai);
  BgzfReader r(bam_path);
  if (!r.ok()) {
    fprintf(stderr, "cannot open %s\n", bam_path.c_str());
    return 1;
  }
  BamHeader hdr;
  if (!read_header(r, hdr)) {
    fprintf(stderr, "bad BAM header\n");
    return 1;
  }

  std::unordered_map<std::string, double> ref_consumed;
  std::map<OrientedPair, Agg> agg;
  std::unordered_set<std::string> processed_paired;
  const char ORIENTS[2] = {'+', '-'};
  auto flip = [](char o) { return o == '+' ? '-' : '+'; };

  BamRec rec;
  while (read_record(r, rec)) {
    uint16_t f = rec.flag;
    if (f & 0x800 || f & 0x100 || f & 0x4) continue;
    if (rec.tid >= 0) {
      int L = cigar_ref_len(rec.cigar);
      if (L > 0) ref_consumed[hdr.names[rec.tid]] += L;
    }
    int main_mapq = rec.mapq;
    int main_nm = rec.nm;
    int ref_len1 = cigar_ref_len(rec.cigar);
    if (!(main_mapq >= P.min_mapq && main_nm <= P.max_nm)) continue;

    bool has_supplement = false;
    if (rec.has_sa && rec.tid >= 0) {
      const std::string& r1 = hdr.names[rec.tid];
      int L1 = hdr.lens[rec.tid];
      int pos1 = rec.pos + 1;
      bool rev1 = (f & 0x10) != 0;
      int reg1 = contig_region(pos1, L1, P.max_end);
      int read_len = cigar_read_len(rec.cigar);
      std::vector<std::pair<int, char>> ops1;
      for (uint32_t c : rec.cigar) ops1.push_back({(int)(c >> 4), CIGAR_OPS[c & 0xF]});
      Interval iv1 = read_interval(ops1, rev1, read_len);

      std::stringstream ss(rec.sa);
      std::string item;
      while (std::getline(ss, item, ';')) {
        if (item.empty()) continue;
        SaItem it = parse_sa(item);
        if (!it.ok) continue;
        if (!(it.mapq >= P.min_mapq && it.nm <= P.max_nm)) continue;
        const std::string& r2 = it.rname;
        if (r1 == r2) continue;
        auto tit = hdr.tid.find(r2);
        if (tit == hdr.tid.end()) continue;
        int L2 = hdr.lens[tit->second];
        int pos2 = it.pos;
        bool rev2 = it.is_rev;
        int reg2 = contig_region(pos2, L2, P.max_end);
        if (reg1 == MIDDLE || reg2 == MIDDLE) continue;
        Interval iv2 = read_interval(parse_cigar_str(it.cigar).ops, rev2, read_len);
        int stitch = can_stitch(iv1, iv2, P.max_gap, P.max_overlap);
        if (stitch < 0) continue;
        bool first1 = stitch == 1;
        bool found = false;
        char oL_found = '+', oR_found = '+';
        for (char oL : ORIENTS) {
          for (char oR : ORIENTS) {
            if (split_layout(rev1, reg1, rev2, reg2, oL, oR, first1)) {
              found = true;
              oL_found = oL;
              oR_found = oR;
              goto split_found;
            }
          }
        }
      split_found:
        if (!found) continue;
        std::string cL = first1 ? r1 : r2;
        std::string cR = first1 ? r2 : r1;
        Evidence ev;
        bool a_le = cL <= cR;
        bool take1_as_a = a_le == first1;
        if (take1_as_a) {
          ev.LA = L1; ev.LB = L2; ev.posA = pos1; ev.posB = pos2;
          ev.regA = reg1; ev.regB = reg2;
          ev.mapqA = main_mapq; ev.nmA = main_nm;
          ev.mapqB = it.mapq; ev.nmB = it.nm;
        } else {
          ev.LA = L2; ev.LB = L1; ev.posA = pos2; ev.posB = pos1;
          ev.regA = reg2; ev.regB = reg1;
          ev.mapqA = it.mapq; ev.nmA = it.nm;
          ev.mapqB = main_mapq; ev.nmB = main_nm;
        }
        bool left_is_a = a_le;  // A == min(cL,cR); left_is_a ⇔ cL is min
        char oL_eval = left_is_a ? oL_found : oR_found;
        char oR_eval = left_is_a ? oR_found : oL_found;
        double score = layout_score(ev, left_is_a, oL_eval, oR_eval, P.max_end);
        if (score > 0.0) {
          std::string kL = cL, kR = cR;
          OrientedPair key{kL, kR, oL_found, oR_found};
          if (kR < kL) {
            std::swap(kL, kR);
            key = OrientedPair{kL, kR, flip(oR_found), flip(oL_found)};
          }
          bool in_fastg = fastg_pairs.count({kL, kR, oL_found, oR_found}) > 0;
          Agg& S = agg[key];
          if (in_fastg) S.supplement += 1; else S.supplement_no_fastg += 1;
          has_supplement = true;
        }
      }
    }

    if (!has_supplement && P.enable_paired && (f & 0x1) && !(f & 0x8) &&
        rec.mtid >= 0 && rec.mtid != rec.tid) {
      if (processed_paired.count(rec.name)) {
        ref_consumed[hdr.names[rec.mtid]] += std::max(0, ref_len1);
        continue;
      }
      const std::string& r1 = hdr.names[rec.tid];
      const std::string& r2 = hdr.names[rec.mtid];
      int L1 = hdr.lens[rec.tid], L2 = hdr.lens[rec.mtid];
      int pos1 = rec.pos + 1, pos2 = rec.mpos + 1;
      bool rev1 = (f & 0x10) != 0, rev2 = (f & 0x20) != 0;
      int reg1 = contig_region(pos1, L1, P.max_end);
      int reg2 = contig_region(pos2, L2, P.max_end);
      if (reg1 == MIDDLE || reg2 == MIDDLE) continue;
      bool found = false;
      char oL_found = '+', oR_found = '+';
      bool first1_found = true;
      for (int order = 0; order < 2 && !found; order++) {
        bool first1 = order == 0;
        for (char oL : ORIENTS) {
          for (char oR : ORIENTS) {
            if (paired_layout(pos1, rev1, reg1, L1, pos2, rev2, reg2, L2, oL, oR,
                              first1, P.max_span_frac)) {
              found = true;
              oL_found = oL;
              oR_found = oR;
              first1_found = first1;
              goto paired_found;
            }
          }
        }
      }
    paired_found:
      if (!found) continue;
      processed_paired.insert(rec.name);
      std::string cL = first1_found ? r1 : r2;
      std::string cR = first1_found ? r2 : r1;
      Evidence ev;
      bool a_le = cL <= cR;
      bool take1_as_a = a_le == first1_found;
      if (take1_as_a) {
        ev.LA = L1; ev.LB = L2; ev.posA = pos1; ev.posB = pos2;
        ev.regA = reg1; ev.regB = reg2;
      } else {
        ev.LA = L2; ev.LB = L1; ev.posA = pos2; ev.posB = pos1;
        ev.regA = reg2; ev.regB = reg1;
      }
      ev.mapqA = ev.mapqB = main_mapq;
      ev.nmA = ev.nmB = main_nm;
      bool left_is_a = a_le;
      char oL_eval = left_is_a ? oL_found : oR_found;
      char oR_eval = left_is_a ? oR_found : oL_found;
      double score = layout_score(ev, left_is_a, oL_eval, oR_eval, P.max_end);
      if (score > 0.0) {
        std::string kL = cL, kR = cR;
        OrientedPair key{kL, kR, oL_found, oR_found};
        if (kR < kL) {
          std::swap(kL, kR);
          key = OrientedPair{kL, kR, flip(oR_found), flip(oL_found)};
        }
        bool in_fastg = fastg_pairs.count({kL, kR, oL_found, oR_found}) > 0;
        Agg& S = agg[key];
        if (in_fastg) S.span += 1; else S.span_no_fastg += 1;
      }
    }
  }

  // SEG table + output
  std::ofstream out(out_path);
  if (!out) {
    fprintf(stderr, "cannot write %s\n", out_path.c_str());
    return 1;
  }
  std::map<std::string, std::pair<double, int>> seg;
  for (size_t i = 0; i < hdr.names.size(); i++) {
    int L = hdr.lens[i];
    if (L <= 0) continue;
    double consumed = 0.0;
    auto it = ref_consumed.find(hdr.names[i]);
    if (it != ref_consumed.end()) consumed = it->second;
    double depth = consumed / std::max(1, L);
    double cnF = avg_depth > 0.0 ? depth / avg_depth : 0.0;
    int cn = (int)std::floor(cnF + 0.5);
    seg[hdr.names[i]] = {depth, cn};
  }
  for (auto& kv : seg) {
    out << "SEG " << kv.first << " ";
    fmt_num(out, kv.second.first);
    out << " " << kv.second.second << "\n";
  }
  for (auto& kv : agg) {
    const Agg& S = kv.second;
    int total = S.supplement + S.span + S.supplement_no_fastg + S.span_no_fastg;
    if (total == 0 || total < P.min_count) continue;
    out << "JUNC " << kv.first.a << " " << kv.first.oa << " " << kv.first.b << " "
        << kv.first.ob << " " << (S.supplement + S.span + S.supplement_no_fastg)
        << " " << S.span_no_fastg << "\n";
  }
  return 0;
}

}  // namespace graphsem

// ---------------------------------------------------------------------------
// depth subcommand (samtools-depth default semantics)
// ---------------------------------------------------------------------------

static int run_depth(const std::string& bam_path, const std::string& out_path) {
  BgzfReader r(bam_path);
  if (!r.ok()) {
    fprintf(stderr, "cannot open %s\n", bam_path.c_str());
    return 1;
  }
  BamHeader hdr;
  if (!read_header(r, hdr)) return 1;
  std::vector<std::vector<int32_t>> depth(hdr.names.size());
  for (size_t i = 0; i < hdr.names.size(); i++) depth[i].assign(hdr.lens[i], 0);
  BamRec rec;
  while (read_record(r, rec)) {
    if (rec.flag & (0x4 | 0x100 | 0x200 | 0x400)) continue;
    if (rec.tid < 0) continue;
    auto& arr = depth[rec.tid];
    int pos = rec.pos;
    for (uint32_t c : rec.cigar) {
      char op = CIGAR_OPS[c & 0xF];
      int n = c >> 4;
      if (op == 'M' || op == 'D' || op == 'N' || op == '=' || op == 'X') {
        int end = std::min<int>(pos + n, arr.size());
        for (int i = pos; i < end; i++) arr[i]++;
        pos += n;
      }
    }
  }
  std::ofstream out(out_path);
  for (size_t t = 0; t < depth.size(); t++) {
    for (size_t i = 0; i < depth[t].size(); i++) {
      if (depth[t][i] > 0)
        out << hdr.names[t] << "\t" << (i + 1) << "\t" << depth[t][i] << "\n";
    }
  }
  return 0;
}

int main(int argc, char** argv) {
  if (argc < 2) {
    fprintf(stderr,
            "usage:\n  %s graph <bam> <fastg_fai> <out> <avg_depth>\n"
            "  %s depth <bam> <out>\n",
            argv[0], argv[0]);
    return 1;
  }
  std::string cmd = argv[1];
  if (cmd == "graph" && argc >= 6) {
    graphsem::Params P;
    // optional overrides (mirror generate_graph.cpp's --max-span-frac /
    // --min-count, generate_graph.cpp:580,588) for differential tests
    if (argc >= 7) P.max_span_frac = atof(argv[6]);
    if (argc >= 8) P.min_count = atoi(argv[7]);
    return graphsem::run_graph(argv[2], argv[3], argv[4], atof(argv[5]), P);
  }
  if (cmd == "depth" && argc >= 4) {
    return run_depth(argv[2], argv[3]);
  }
  fprintf(stderr, "bad arguments\n");
  return 1;
}
