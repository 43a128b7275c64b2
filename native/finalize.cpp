// Native single-end finalize for bwamem_tpu: alignment regions -> SAM
// record text for a whole chunk in one call.
//
// Covers the serial per-read logic downstream of the extension waves
// (behavioral spec: bwamem_tpu/core/{region,align,sam,pipeline}.py,
// themselves transcriptions of software/bwamem.c:705-1553 and
// software/bwa.c:96-229):
//   mark_primary      secondary marking with hash_64 tie-breaks
//   reg2sam_se        region filtering, supplementary flags, mapq caps
//   reg2aln           fix_xref + banded global realign (band doubling)
//                     + clip/NM/MD, via the native ksw_global2
//   aln2sam           byte-exact SAM formatting incl. SA tags
//
// The banded global realignments run here on the host (the regions are
// tiny) instead of as device waves — the device
// keeps the seeding/SMEM/extension stages, mirroring the reference's
// accelerator/CPU split (SURVEY.md §1).

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

#include "common.h"

extern "C" {
// from ksw.cpp
int32_t bm_ksw_global2(int qlen, const uint8_t* query, int tlen,
                       const uint8_t* target, const int8_t* mat, int o_del,
                       int e_del, int o_ins, int e_ins, int w,
                       int want_cigar, uint32_t* out_cigar,
                       int32_t* n_cigar);
void bm_ksw_align2(int qlen, const uint8_t* query, int tlen,
                   const uint8_t* target, const int8_t* mat, int o_del,
                   int e_del, int o_ins, int e_ins, int xtra, int32_t* out7);
}

namespace {

using bm::hash64;
using bm::ks_introsort;

constexpr int kMemFAll = 0x8;
constexpr int kMemFNoMulti = 0x10;

struct Opt {
  int32_t a, b, o_del, e_del, o_ins, e_ins, w, T, flag, min_seed_len;
  double mask_level, mapq_coef_len, mapq_coef_fac;
};

struct Reg {
  int64_t rb, re;
  int32_t qb, qe, score, truesc, sub, csub, sub_n, w, seedcov, secondary;
  uint64_t hash;
};

struct Aln {
  int64_t pos = 0;
  int32_t rid = -1, flag = 0, is_rev = 0, mapq = 0, NM = 0, score = 0,
          sub = 0;
  std::vector<uint32_t> cigar;  // len<<4|op, MIDSH = 0..4
  std::string MD;
};

struct Ref {
  int64_t l_pac;
  const uint8_t* pac;
  int32_t n_anns;
  const int64_t* ann_off;
  const int32_t* ann_len;
  std::vector<const char*> ann_name;
};

// ---- reference fetch (bns_get_seq; spec: index/bntseq.py get_seq) ----

inline std::vector<uint8_t> get_seq(const Ref& ref, int64_t beg,
                                   int64_t end) {
  return bm::get_seq(ref.l_pac, ref.pac, beg, end);
}

// bns_depos: doubled-reference position -> forward strand
inline int64_t depos(const Ref& ref, int64_t pos, bool* is_rev) {
  *is_rev = pos >= ref.l_pac;
  return *is_rev ? (ref.l_pac << 1) - 1 - pos : pos;
}

// bns_pos2rid: forward position -> contig id (exact binary-search walk)
int pos2rid(const Ref& ref, int64_t pos_f) {
  if (pos_f >= ref.l_pac) return -1;
  int left = 0, mid = 0, right = ref.n_anns;
  while (left < right) {
    mid = (left + right) >> 1;
    if (pos_f >= ref.ann_off[mid]) {
      if (mid == ref.n_anns - 1) break;
      if (pos_f < ref.ann_off[mid + 1]) break;
      left = mid + 1;
    } else {
      right = mid;
    }
  }
  return mid;
}

// ---- mem_mark_primary_se (spec: core/region.py mark_primary) ----

void mark_primary(const Opt& opt, std::vector<Reg>& regs, int64_t rid) {
  if (regs.empty()) return;
  for (size_t i = 0; i < regs.size(); ++i) {
    regs[i].sub = 0;
    regs[i].secondary = -1;
    regs[i].hash = hash64(static_cast<uint64_t>(rid) + i);
  }
  ks_introsort(regs, [](const Reg& a, const Reg& b) {
    return a.score > b.score || (a.score == b.score && a.hash < b.hash);
  });
  int tmp = opt.a + opt.b;
  tmp = tmp > opt.o_del + opt.e_del ? tmp : opt.o_del + opt.e_del;
  tmp = tmp > opt.o_ins + opt.e_ins ? tmp : opt.o_ins + opt.e_ins;
  std::vector<int> z{0};
  for (int i = 1; i < static_cast<int>(regs.size()); ++i) {
    size_t k = 0;
    for (; k < z.size(); ++k) {
      int j = z[k];
      int b_max = regs[j].qb > regs[i].qb ? regs[j].qb : regs[i].qb;
      int e_min = regs[j].qe < regs[i].qe ? regs[j].qe : regs[i].qe;
      if (e_min > b_max) {
        int min_l = regs[i].qe - regs[i].qb < regs[j].qe - regs[j].qb
                        ? regs[i].qe - regs[i].qb
                        : regs[j].qe - regs[j].qb;
        if (e_min - b_max >= min_l * opt.mask_level) {
          if (regs[j].sub == 0) regs[j].sub = regs[i].score;
          if (regs[j].score - regs[i].score <= tmp) ++regs[j].sub_n;
          break;
        }
      }
    }
    if (k == z.size())
      z.push_back(i);
    else
      regs[i].secondary = z[k];
  }
}

// ---- mem_approx_mapq_se (spec: core/region.py approx_mapq_se) ----

int approx_mapq_se(const Opt& opt, const Reg& a) {
  int sub = a.sub ? a.sub : opt.min_seed_len * opt.a;
  sub = a.csub > sub ? a.csub : sub;
  if (sub >= a.score) return 0;
  int64_t len_r = a.re - a.rb;
  int length = a.qe - a.qb;
  if (len_r > length) length = static_cast<int>(len_r);
  double identity =
      1.0 - static_cast<double>(static_cast<int64_t>(length) * opt.a -
                                a.score) /
                (opt.a + opt.b) / length;
  int mapq;
  if (a.score == 0) {
    mapq = 0;
  } else if (opt.mapq_coef_len > 0) {
    double tmp = length < opt.mapq_coef_len
                     ? 1.0
                     : opt.mapq_coef_fac / std::log(length);
    tmp *= identity * identity;
    mapq = static_cast<int>(6.02 * (a.score - sub) / opt.a * tmp * tmp + .499);
  } else {
    mapq = static_cast<int>(
        30.0 * (1.0 - static_cast<double>(sub) / a.score) *
            std::log(a.seedcov) +
        .499);
    if (identity < 0.95)
      mapq = static_cast<int>(mapq * identity * identity + .499);
  }
  if (a.sub_n > 0)
    mapq -= static_cast<int>(4.343 * std::log(a.sub_n + 1.) + .499);
  if (mapq > 60) mapq = 60;
  if (mapq < 0) mapq = 0;
  return mapq;
}

// ---- bwa_gen_cigar2 (spec: core/align.py gen_cigar_gen) ----

int infer_bw(int l1, int l2, int score, int a, int q, int r) {
  if (l1 == l2 && l1 * a - score < (q + r - a) * 2) return 0;
  int w = static_cast<int>(
      static_cast<double>((l1 < l2 ? l1 : l2) * a - score - q) / r + 2.0);
  int d = l1 > l2 ? l1 - l2 : l2 - l1;
  return w > d ? w : d;
}

// query is the nt4 slice [qb,qe); returns false when rejected (cigar
// null in the spec).  On success fills cigar/MD/score/NM.
bool gen_cigar(const Opt& opt, const int8_t* mat, int w_, const Ref& ref,
               const uint8_t* query, int l_query, int64_t rb, int64_t re,
               std::vector<uint32_t>* cigar, std::string* md,
               int32_t* score_out, int32_t* nm_out) {
  cigar->clear();
  md->clear();
  *score_out = 0;
  *nm_out = -1;
  if (l_query <= 0 || rb >= re || (rb < ref.l_pac && ref.l_pac < re))
    return false;
  std::vector<uint8_t> rseq = get_seq(ref, rb, re);
  if (static_cast<int64_t>(rseq.size()) != re - rb) return false;
  std::vector<uint8_t> qbuf(query, query + l_query);
  if (rb >= ref.l_pac) {  // reverse both for leftmost indel placement
    for (int i = 0; i < l_query / 2; ++i)
      std::swap(qbuf[i], qbuf[l_query - 1 - i]);
    for (size_t i = 0; i < rseq.size() / 2; ++i)
      std::swap(rseq[i], rseq[rseq.size() - 1 - i]);
  }
  int32_t score;
  if (l_query == re - rb && w_ == 0) {
    cigar->push_back(static_cast<uint32_t>(l_query) << 4 | 0);
    score = 0;
    for (int i = 0; i < l_query; ++i) score += mat[rseq[i] * 5 + qbuf[i]];
  } else {
    int max_ins = static_cast<int>(
        static_cast<double>(((l_query + 1) >> 1) * mat[0] - opt.o_ins) /
            opt.e_ins +
        1.0);
    int max_del = static_cast<int>(
        static_cast<double>(((l_query + 1) >> 1) * mat[0] - opt.o_del) /
            opt.e_del +
        1.0);
    int max_gap = max_ins > max_del ? max_ins : max_del;
    if (max_gap < 1) max_gap = 1;
    int64_t tl = re - rb;
    int w = static_cast<int>(
        (max_gap + (tl > l_query ? tl - l_query : l_query - tl) + 1) >> 1);
    if (w > w_) w = w_;
    int min_w = static_cast<int>(tl > l_query ? tl - l_query : l_query - tl) + 3;
    if (w < min_w) w = min_w;
    std::vector<uint32_t> cbuf(l_query + rseq.size() + 4);
    int32_t ncig = 0;
    score = bm_ksw_global2(l_query, qbuf.data(),
                           static_cast<int>(rseq.size()), rseq.data(), mat,
                           opt.o_del, opt.e_del, opt.o_ins, opt.e_ins, w, 1,
                           cbuf.data(), &ncig);
    cigar->assign(cbuf.begin(), cbuf.begin() + ncig);
  }
  // NM and MD over the (possibly reversed) sequences
  static const char kBaseF[] = "ACGTN";
  static const char kBaseR[] = "TGCAN";
  const char* base_tab = rb < ref.l_pac ? kBaseF : kBaseR;
  char num[16];
  int x = 0, y = 0, u = 0, n_mm = 0, n_gap = 0;
  const int n_cigar = static_cast<int>(cigar->size());
  for (int ki = 0; ki < n_cigar; ++ki) {
    int op = (*cigar)[ki] & 0xF;
    int ln = (*cigar)[ki] >> 4;
    if (op == 0) {
      for (int i = 0; i < ln; ++i) {
        if (qbuf[x + i] != rseq[y + i]) {
          std::snprintf(num, sizeof num, "%d", u);
          *md += num;
          *md += base_tab[rseq[y + i]];
          u = 0;
          ++n_mm;
        } else {
          ++u;
        }
      }
      x += ln;
      y += ln;
    } else if (op == 2) {
      if (ki > 0 && ki < n_cigar - 1) {
        std::snprintf(num, sizeof num, "%d", u);
        *md += num;
        *md += '^';
        for (int i = 0; i < ln; ++i) *md += base_tab[rseq[y + i]];
        u = 0;
        n_gap += ln;
      }
      y += ln;
    } else if (op == 1) {
      x += ln;
      n_gap += ln;
    }
  }
  std::snprintf(num, sizeof num, "%d", u);
  *md += num;
  *score_out = score;
  *nm_out = n_mm + n_gap;
  return true;
}

// ---- bwa_fix_xref2 (spec: core/align.py fix_xref_gen) ----

int fix_xref(const Opt& opt, const int8_t* mat, const Ref& ref,
             const uint8_t* query, int* qb, int* qe, int64_t* rb,
             int64_t* re) {
  if (*rb < ref.l_pac && ref.l_pac < *re) return -1;
  bool is_rev;
  int64_t fm_pos = depos(ref, (*rb + *re) >> 1, &is_rev);
  int rid = pos2rid(ref, fm_pos);
  int64_t off = ref.ann_off[rid], len = ref.ann_len[rid];
  int64_t cb = is_rev ? (ref.l_pac << 1) - (off + len) : off;
  int64_t ce = cb + len;
  if (cb > *rb || ce < *re) {
    if (cb < *rb) cb = *rb;
    if (ce > *re) ce = *re;
    std::vector<uint32_t> cigar;
    std::string md;
    int32_t sc, nm;
    bool ok = gen_cigar(opt, mat, opt.w, ref, query + *qb, *qe - *qb, *rb,
                        *re, &cigar, &md, &sc, &nm);
    int64_t x = *rb;
    int y = *qb;
    if (ok) {
      for (uint32_t cg : cigar) {
        int op = cg & 0xF;
        int64_t ln = cg >> 4;
        if (op == 0) {
          if (x <= cb && cb < x + ln) {
            *qb = y + static_cast<int>(cb - x);
            *rb = cb;
          }
          if (x < ce && ce <= x + ln) {
            *qe = y + static_cast<int>(ce - x);
            *re = ce;
            break;
          }
          x += ln;
          y += static_cast<int>(ln);
        } else if (op == 1) {
          y += static_cast<int>(ln);
        } else if (op == 2) {
          if (x <= cb && cb < x + ln) {
            *qb = y;
            *rb = x + ln;
          }
          if (x < ce && ce <= x + ln) {
            *qe = y;
            *re = x;
            break;
          }
          x += ln;
        } else {
          return -3;  // unexpected op (spec raises)
        }
      }
    }
  }
  return (*qb == *qe || *rb == *re) ? -2 : 0;
}

// ---- mem_reg2aln (spec: core/align.py reg2aln_gen) ----

// returns 0 ok, <0 unrecoverable (caller falls back to the Python path)
int reg2aln(const Opt& opt, const int8_t* mat, const Ref& ref, int l_query,
            const uint8_t* query, const Reg* ar, Aln* a) {
  *a = Aln();
  if (ar == nullptr || ar->rb < 0 || ar->re < 0) {
    a->rid = -1;
    a->pos = -1;
    a->flag |= 0x4;
    return 0;
  }
  int qb = ar->qb, qe = ar->qe;
  int64_t rb = ar->rb, re = ar->re;
  a->mapq = ar->secondary < 0 ? approx_mapq_se(opt, *ar) : 0;
  if (ar->secondary >= 0) a->flag |= 0x100;
  int st = fix_xref(opt, mat, ref, query, &qb, &qe, &rb, &re);
  if (st < 0) return -1;
  int tmp = infer_bw(qe - qb, static_cast<int>(re - rb), ar->truesc, opt.a,
                     opt.o_del, opt.e_del);
  int w2 = infer_bw(qe - qb, static_cast<int>(re - rb), ar->truesc, opt.a,
                    opt.o_ins, opt.e_ins);
  if (w2 < tmp) w2 = tmp;
  if (w2 > opt.w) w2 = w2 < ar->w ? w2 : ar->w;
  int i = 0;
  int32_t last_sc = -(1 << 30);
  std::vector<uint32_t> cigar;
  std::string md;
  int32_t score = 0, NM = -1;
  for (;;) {
    gen_cigar(opt, mat, w2, ref, query + qb, qe - qb, rb, re, &cigar, &md,
              &score, &NM);
    if (score == last_sc) break;
    last_sc = score;
    w2 <<= 1;
    ++i;
    if (!(i < 3 && score < ar->truesc - opt.a)) break;
  }
  a->NM = NM;
  bool is_rev;
  int64_t pos = depos(ref, rb < ref.l_pac ? rb : re - 1, &is_rev);
  a->is_rev = is_rev ? 1 : 0;
  if (!cigar.empty()) {  // squeeze out leading/trailing deletions
    if ((cigar[0] & 0xF) == 2) {
      pos += cigar[0] >> 4;
      cigar.erase(cigar.begin());
    } else if ((cigar.back() & 0xF) == 2) {
      cigar.pop_back();
    }
  }
  if (qb != 0 || qe != l_query) {  // soft clipping
    int clip5 = is_rev ? l_query - qe : qb;
    int clip3 = is_rev ? qb : l_query - qe;
    if (clip5)
      cigar.insert(cigar.begin(), static_cast<uint32_t>(clip5) << 4 | 3);
    if (clip3) cigar.push_back(static_cast<uint32_t>(clip3) << 4 | 3);
  }
  a->cigar = std::move(cigar);
  a->MD = std::move(md);
  a->rid = pos2rid(ref, pos);
  a->pos = pos - ref.ann_off[a->rid];
  a->score = ar->score;
  a->sub = ar->sub > ar->csub ? ar->sub : ar->csub;
  return 0;
}

// ---- mem_aln2sam, single-end (spec: core/sam.py aln2sam, m=None) ----

inline int64_t get_rlen(const std::vector<uint32_t>& cigar) {
  int64_t l = 0;
  for (uint32_t cg : cigar) {
    int op = cg & 0xF;
    if (op == 0 || op == 2) l += cg >> 4;
  }
  return l;
}

void append_int(std::string* out, int64_t v) {
  char buf[24];
  std::snprintf(buf, sizeof buf, "%lld", static_cast<long long>(v));
  *out += buf;
}

// mem_aln2sam (spec: core/sam.py aln2sam); `m_` may be null (SE)
void aln2sam(const Ref& ref, const char* name, const char* comment,
             const char* qual, const uint8_t* seq, int l_seq, int n,
             const std::vector<Aln>& alns, int which, const Aln* m_,
             const char* rg_id, std::string* out) {
  static const char kCig[] = "MIDSH";
  static const char kSeqF[] = "ACGTN";
  static const char kSeqR[] = "TGCAN";
  Aln p = alns[which];  // both records are mutated by the mate copying
  Aln m;
  bool has_m = m_ != nullptr;
  if (has_m) m = *m_;

  p.flag |= has_m ? 0x1 : 0;
  p.flag |= p.rid < 0 ? 0x4 : 0;
  p.flag |= (has_m && m.rid < 0) ? 0x8 : 0;
  if (p.rid < 0 && has_m && m.rid >= 0) {  // copy mate to alignment
    p.rid = m.rid;
    p.pos = m.pos;
    p.is_rev = m.is_rev;
    p.cigar.clear();
  }
  if (has_m && m.rid < 0 && p.rid >= 0) {  // copy alignment to mate
    m.rid = p.rid;
    m.pos = p.pos;
    m.is_rev = p.is_rev;
    m.cigar.clear();
  }
  p.flag |= p.is_rev ? 0x10 : 0;
  p.flag |= (has_m && m.is_rev) ? 0x20 : 0;

  *out += name;
  *out += '\t';
  append_int(out, (p.flag & 0xFFFF) | ((p.flag & 0x10000) ? 0x100 : 0));
  *out += '\t';
  if (p.rid >= 0) {
    *out += ref.ann_name[p.rid];
    *out += '\t';
    append_int(out, p.pos + 1);
    *out += '\t';
    append_int(out, p.mapq);
    *out += '\t';
    if (!p.cigar.empty()) {
      for (uint32_t cg : p.cigar) {
        int c = cg & 0xF;
        if (c == 3 || c == 4) c = which ? 4 : 3;  // hard-clip supplementary
        append_int(out, cg >> 4);
        *out += kCig[c];
      }
    } else {
      *out += '*';
    }
  } else {
    *out += "*\t0\t0\t*";
  }
  *out += '\t';

  if (has_m && m.rid >= 0) {
    if (p.rid == m.rid)
      *out += '=';
    else
      *out += ref.ann_name[m.rid];
    *out += '\t';
    append_int(out, m.pos + 1);
    *out += '\t';
    if (p.rid == m.rid) {
      int64_t p0 = p.pos + (p.is_rev ? get_rlen(p.cigar) - 1 : 0);
      int64_t p1 = m.pos + (m.is_rev ? get_rlen(m.cigar) - 1 : 0);
      if (m.cigar.empty() || p.cigar.empty()) {
        *out += '0';
      } else {
        int64_t sign = p0 > p1 ? 1 : (p0 < p1 ? -1 : 0);
        append_int(out, -(p0 - p1 + sign));
      }
    } else {
      *out += '0';
    }
  } else {
    *out += "*\t0\t0";
  }
  *out += '\t';

  // SEQ and QUAL
  bool sec = (p.flag & 0x100) != 0;
  if (sec) {
    *out += "*\t*";
  } else if (!p.is_rev) {
    int qb = 0, qe = l_seq;
    if (!p.cigar.empty() && which) {
      int c0 = p.cigar.front() & 0xF, cl = p.cigar.back() & 0xF;
      if (c0 == 3 || c0 == 4) qb += p.cigar.front() >> 4;
      if (cl == 3 || cl == 4) qe -= p.cigar.back() >> 4;
    }
    for (int i = qb; i < qe; ++i) *out += kSeqF[seq[i]];
    *out += '\t';
    if (qual && qual[0])
      out->append(qual + qb, qual + qe);
    else
      *out += '*';
  } else {
    int qb = 0, qe = l_seq;
    if (!p.cigar.empty() && which) {
      int c0 = p.cigar.front() & 0xF, cl = p.cigar.back() & 0xF;
      if (c0 == 3 || c0 == 4) qe -= p.cigar.front() >> 4;
      if (cl == 3 || cl == 4) qb += p.cigar.back() >> 4;
    }
    for (int i = qe - 1; i >= qb; --i) *out += kSeqR[seq[i]];
    *out += '\t';
    if (qual && qual[0]) {
      for (int i = qe - 1; i >= qb; --i) *out += qual[i];
    } else {
      *out += '*';
    }
  }

  if (!p.cigar.empty()) {
    *out += "\tNM:i:";
    append_int(out, p.NM);
    *out += "\tMD:Z:";
    *out += p.MD;
  }
  if (p.score >= 0) {
    *out += "\tAS:i:";
    append_int(out, p.score);
  }
  if (p.sub >= 0) {
    *out += "\tXS:i:";
    append_int(out, p.sub);
  }
  if (rg_id && rg_id[0]) {
    *out += "\tRG:Z:";
    *out += rg_id;
  }
  if (!(p.flag & 0x100)) {
    bool any = false;
    for (int i = 0; i < n; ++i)
      if (i != which && !(alns[i].flag & 0x100)) any = true;
    if (any) {
      *out += "\tSA:Z:";
      for (int i = 0; i < n; ++i) {
        const Aln& r = alns[i];
        if (i == which || (r.flag & 0x100)) continue;
        *out += ref.ann_name[r.rid];
        *out += ',';
        append_int(out, r.pos + 1);
        *out += ',';
        *out += r.is_rev ? '-' : '+';
        *out += ',';
        for (uint32_t cg : r.cigar) {
          append_int(out, cg >> 4);
          *out += kCig[cg & 0xF];
        }
        *out += ',';
        append_int(out, r.mapq);
        *out += ',';
        append_int(out, r.NM);
        *out += ';';
      }
    }
  }
  if (comment && comment[0]) {
    *out += '\t';
    *out += comment;
  }
  *out += '\n';
}

// ---- mem_sort_and_dedup (spec: core/region.py sort_and_dedup) ----

void sort_and_dedup(std::vector<Reg>& regs, double mask_level_redun) {
  if (regs.size() <= 1) return;
  ks_introsort(regs, [](const Reg& a, const Reg& b) {  // mem_ars2
    return a.re < b.re;
  });
  for (int i = 1; i < static_cast<int>(regs.size()); ++i) {
    Reg& p = regs[i];
    if (p.rb >= regs[i - 1].re) continue;
    int j = i - 1;
    while (j >= 0 && p.rb < regs[j].re) {
      Reg& q = regs[j];
      --j;
      if (q.qe == q.qb) continue;  // already excluded
      int64_t o_r = q.re - p.rb;
      int64_t o_q = q.qb < p.qb ? q.qe - p.qb : p.qe - q.qb;
      int64_t m_r = q.re - q.rb < p.re - p.rb ? q.re - q.rb : p.re - p.rb;
      int64_t m_q = q.qe - q.qb < p.qe - p.qb ? q.qe - q.qb : p.qe - p.qb;
      if (o_r > mask_level_redun * m_r && o_q > mask_level_redun * m_q) {
        if (p.score < q.score) {
          p.qe = p.qb;
          break;
        }
        q.qe = q.qb;
      }
    }
  }
  {
    std::vector<Reg> kept;
    for (const Reg& r : regs)
      if (r.qe > r.qb) kept.push_back(r);
    regs.swap(kept);
  }
  ks_introsort(regs, [](const Reg& a, const Reg& b) {  // mem_ars
    return a.score > b.score ||
           (a.score == b.score &&
            (a.rb < b.rb || (a.rb == b.rb && a.qb < b.qb)));
  });
  for (size_t i = 1; i < regs.size(); ++i)
    if (regs[i].score == regs[i - 1].score && regs[i].rb == regs[i - 1].rb &&
        regs[i].qb == regs[i - 1].qb)
      regs[i].qe = regs[i].qb;
  if (!regs.empty()) {
    std::vector<Reg> out{regs[0]};
    for (size_t i = 1; i < regs.size(); ++i)
      if (regs[i].qe > regs[i].qb) out.push_back(regs[i]);
    regs.swap(out);
  }
}

// ---- paired-end helpers (spec: core/pair.py) ----

struct PeStatC {
  int64_t low, high;
  int32_t failed;
  double avg, std;
};

struct OptPe {
  int32_t pen_unpaired, max_matesw;
  double mask_level_redun;
};

constexpr int kMemFNoPairing = 0x4;
constexpr int kMemFNoRescue = 0x20;
constexpr double kMSqrt12 = 0.7071067811865476;

// mem_infer_dir: orientation in {0:FF,1:FR,2:RF,3:RR} and distance
inline int infer_dir(int64_t l_pac, int64_t b1, int64_t b2,
                     int64_t* dist) {
  bool r1 = b1 >= l_pac, r2 = b2 >= l_pac;
  int64_t p2 = (r1 == r2) ? b2 : (l_pac << 1) - 1 - b2;
  *dist = p2 > b1 ? p2 - b1 : b1 - p2;
  return ((r1 == r2) ? 0 : 1) ^ ((p2 > b1) ? 0 : 3);
}

// mem_matesw: rescue a mate by local SW inside each plausible insert
// window; rescued regions are score-sorted into `ma`
int matesw(const Opt& opt, const OptPe& ope, const int8_t* mat,
           const Ref& ref, const PeStatC* pes, const Reg& a,
           const uint8_t* mate_seq, int l_ms, std::vector<Reg>* ma) {
  int skip[4];
  for (int r = 0; r < 4; ++r) skip[r] = pes[r].failed ? 1 : 0;
  for (const Reg& reg : *ma) {
    int64_t dist;
    int r = infer_dir(ref.l_pac, a.rb, reg.rb, &dist);
    if (pes[r].low <= dist && dist <= pes[r].high) skip[r] = 1;
  }
  if (skip[0] + skip[1] + skip[2] + skip[3] == 4) return 0;
  int n = 0;
  for (int r = 0; r < 4; ++r) {
    if (skip[r]) continue;
    bool is_rev = (r >> 1) != (r & 1);
    bool is_larger = !(r >> 1);
    std::vector<uint8_t> seq_rc;
    const uint8_t* seq = mate_seq;
    if (is_rev) {
      seq_rc.resize(l_ms);
      for (int i = 0; i < l_ms; ++i) {
        uint8_t b = mate_seq[l_ms - 1 - i];
        seq_rc[i] = b < 4 ? 3 - b : 4;
      }
      seq = seq_rc.data();
    }
    int64_t rb, re;
    if (!is_rev) {
      rb = is_larger ? a.rb + pes[r].low : a.rb - pes[r].high;
      re = (is_larger ? a.rb + pes[r].high : a.rb - pes[r].low) + l_ms;
    } else {
      rb = (is_larger ? a.rb + pes[r].low : a.rb - pes[r].high) - l_ms;
      re = is_larger ? a.rb + pes[r].high : a.rb - pes[r].low;
    }
    if (rb < 0) rb = 0;
    if (re > ref.l_pac << 1) re = ref.l_pac << 1;
    std::vector<uint8_t> rref = get_seq(ref, rb, re);
    if (static_cast<int64_t>(rref.size()) == re - rb) {
      int xtra = 0x40000 /*XSUBO*/ | 0x80000 /*XSTART*/ |
                 ((static_cast<int64_t>(l_ms) * opt.a < 250) ? 0x10000 : 0) |
                 (opt.min_seed_len * opt.a);
      int32_t o7[7];
      bm_ksw_align2(l_ms, seq, static_cast<int>(rref.size()), rref.data(),
                    mat, opt.o_del, opt.e_del, opt.o_ins, opt.e_ins, xtra,
                    o7);
      // o7 = {score, te, qe, score2, te2, tb, qb}
      if (o7[0] >= opt.min_seed_len && o7[6] >= 0) {
        Reg b{};
        b.qb = is_rev ? l_ms - (o7[2] + 1) : o7[6];
        b.qe = is_rev ? l_ms - o7[6] : o7[2] + 1;
        b.rb = is_rev ? (ref.l_pac << 1) - (rb + o7[1] + 1) : rb + o7[5];
        b.re = is_rev ? (ref.l_pac << 1) - (rb + o7[5]) : rb + o7[1] + 1;
        b.score = o7[0];
        b.csub = o7[3];
        b.secondary = -1;
        int64_t cov = b.re - b.rb < b.qe - b.qb ? b.re - b.rb : b.qe - b.qb;
        b.seedcov = static_cast<int32_t>(cov >> 1);
        b.truesc = 0;
        b.sub = 0;
        b.sub_n = 0;
        b.w = 0;
        b.hash = 0;
        // insert keeping ma sorted by score (bwamem_pair.c:160-166)
        size_t ins = 0;
        while (ins < ma->size() && (*ma)[ins].score >= b.score) ++ins;
        ma->insert(ma->begin() + ins, b);
      }
      ++n;
    }
    if (n) sort_and_dedup(*ma, ope.mask_level_redun);
  }
  return n;
}

// mem_pair: best proper pair by sorted-position scan; returns the pair
// score (0 = none) and fills sub/n_sub/z
int mem_pair(const Opt& opt, const Ref& ref, const PeStatC* pes,
             const std::vector<Reg>& a0, const std::vector<Reg>& a1,
             int64_t pair_id, int* sub_out, int* n_sub_out, int z[2]) {
  std::vector<std::pair<int64_t, uint64_t>> v;
  for (int r = 0; r < 2; ++r) {
    const std::vector<Reg>& regs = r ? a1 : a0;
    for (size_t i = 0; i < regs.size(); ++i) {
      const Reg& e = regs[i];
      int64_t key_x = e.rb < ref.l_pac ? e.rb : (ref.l_pac << 1) - 1 - e.rb;
      uint64_t key_y = (static_cast<uint64_t>(e.score) << 32) | (i << 2) |
                       ((e.rb >= ref.l_pac ? 1ull : 0ull) << 1) |
                       static_cast<uint64_t>(r);
      v.emplace_back(key_x, key_y);
    }
  }
  std::sort(v.begin(), v.end());
  std::vector<std::pair<uint64_t, uint64_t>> u;
  int y[4] = {-1, -1, -1, -1};
  for (size_t i = 0; i < v.size(); ++i) {
    for (int r = 0; r < 2; ++r) {
      int dr = (r << 1) | ((v[i].second >> 1) & 1);
      if (pes[dr].failed) continue;
      int which = (r << 1) | ((v[i].second & 1) ^ 1);
      if (y[which] < 0) continue;
      for (int k = y[which]; k >= 0; --k) {
        if (static_cast<int>(v[k].second & 3) != which) continue;
        int64_t dist = v[i].first - v[k].first;
        if (dist > pes[dr].high) break;
        if (dist < pes[dr].low) continue;
        double ns = (dist - pes[dr].avg) / pes[dr].std;
        double ef = 2.0 * std::erfc(std::fabs(ns) * kMSqrt12);
        int q;
        if (ef > 0.0) {
          q = static_cast<int>(
              static_cast<double>((v[i].second >> 32) +
                                  (v[k].second >> 32)) +
              .721 * std::log(ef) * opt.a + .499);
        } else {  // erfc underflow: log(0) = -inf clamps to 0
          q = 0;
        }
        if (q < 0) q = 0;
        uint64_t uy = (static_cast<uint64_t>(k) << 32) | i;
        uint64_t ux =
            (static_cast<uint64_t>(q) << 32) |
            (hash64(uy ^ (static_cast<uint64_t>(pair_id) << 8)) &
             0xFFFFFFFFull);
        u.emplace_back(ux, uy);
      }
    }
    y[v[i].second & 3] = static_cast<int>(i);
  }
  z[0] = z[1] = -1;
  if (u.empty()) {
    *sub_out = 0;
    *n_sub_out = 0;
    return 0;
  }
  int tmp = opt.a + opt.b;
  tmp = tmp > opt.o_del + opt.e_del ? tmp : opt.o_del + opt.e_del;
  tmp = tmp > opt.o_ins + opt.e_ins ? tmp : opt.o_ins + opt.e_ins;
  std::sort(u.begin(), u.end());
  size_t i = u.back().second >> 32;
  size_t k = u.back().second & 0xFFFFFFFFull;
  z[v[i].second & 1] = static_cast<int>((v[i].second & 0xFFFFFFFFull) >> 2);
  z[v[k].second & 1] = static_cast<int>((v[k].second & 0xFFFFFFFFull) >> 2);
  int ret = static_cast<int>(u.back().first >> 32);
  int sub = u.size() > 1 ? static_cast<int>(u[u.size() - 2].first >> 32) : 0;
  int n_sub = 0;
  for (int j = static_cast<int>(u.size()) - 2; j >= 0; --j)
    if (sub - static_cast<int>(u[j].first >> 32) <= tmp) ++n_sub;
  *sub_out = sub;
  *n_sub_out = n_sub;
  return ret;
}

inline int raw_mapq(int diff, int a) {
  return static_cast<int>(6.02 * diff / a + .499);
}

struct ReadView {
  const char* name;
  const char* comment;
  const char* qual;
  const uint8_t* seq;
  int l_seq;
};

// mem_reg2sam_se (spec: core/pipeline.py reg2sam_se_gen); `regs` must
// already be primary-marked.  Returns false on an unrecoverable
// reg2aln (caller falls back to the Python path).
bool reg2sam_se(const Opt& opt, const int8_t* mat, const Ref& ref,
                const ReadView& rd, const std::vector<Reg>& regs,
                int extra_flag, const Aln* mate, const char* rg_id,
                std::string* out) {
  std::vector<Aln> aa;
  for (size_t k = 0; k < regs.size(); ++k) {
    const Reg& p = regs[k];
    if (p.score < opt.T) continue;
    if (p.secondary >= 0 && !(opt.flag & kMemFAll)) continue;
    if (p.secondary >= 0 && p.score < regs[p.secondary].score * .5)
      continue;
    Aln q;
    if (reg2aln(opt, mat, ref, rd.l_seq, rd.seq, &p, &q) < 0) return false;
    q.flag |= extra_flag;
    if (p.secondary >= 0) q.sub = -1;
    if (k && p.secondary < 0)
      q.flag |= (opt.flag & kMemFNoMulti) ? 0x10000 : 0x800;
    if (k && q.mapq > aa[0].mapq) q.mapq = aa[0].mapq;
    aa.push_back(std::move(q));
  }
  if (aa.empty()) {
    Aln t;
    reg2aln(opt, mat, ref, rd.l_seq, rd.seq, nullptr, &t);
    t.flag |= extra_flag;
    aln2sam(ref, rd.name, rd.comment, rd.qual, rd.seq, rd.l_seq, 1,
            std::vector<Aln>{t}, 0, mate, rg_id, out);
  } else {
    for (size_t k = 0; k < aa.size(); ++k)
      aln2sam(ref, rd.name, rd.comment, rd.qual, rd.seq, rd.l_seq,
              static_cast<int>(aa.size()), aa, static_cast<int>(k), mate,
              rg_id, out);
  }
  return true;
}

// mem_sam_pe (spec: core/pair.py sam_pe_gen): finalize one read pair.
// Mutates a0/a1 (rescue, primary marking).  Returns false on an
// unrecoverable reg2aln (caller falls back to the Python path).
bool sam_pe(const Opt& opt, const OptPe& ope, const int8_t* mat,
            const Ref& ref, const PeStatC* pes, int64_t pair_id,
            const ReadView& s0, const ReadView& s1, std::vector<Reg>* a0,
            std::vector<Reg>* a1, const char* rg_id, std::string* out,
            size_t* split_pos) {
  std::vector<Reg>* a[2] = {a0, a1};
  const ReadView* s[2] = {&s0, &s1};
  int extra_flag = 1;
  if (!(opt.flag & kMemFNoRescue)) {
    // snapshot rescue candidates for BOTH ends before any rescue runs
    std::vector<Reg> b[2];
    for (int i = 0; i < 2; ++i)
      for (const Reg& reg : *a[i])
        if (reg.score >= (*a[i])[0].score - ope.pen_unpaired)
          b[i].push_back(reg);
    for (int i = 0; i < 2; ++i)
      for (size_t j = 0; j < b[i].size(); ++j) {
        if (static_cast<int32_t>(j) >= ope.max_matesw) break;
        matesw(opt, ope, mat, ref, pes, b[i][j], s[1 - i]->seq,
               s[1 - i]->l_seq, a[1 - i]);
      }
  }
  mark_primary(opt, *a[0], (pair_id << 1) | 0);
  mark_primary(opt, *a[1], (pair_id << 1) | 1);
  if (!(opt.flag & kMemFNoPairing)) {
    int o = 0, subo = 0, n_sub = 0;
    int z[2] = {-1, -1};
    if (!a[0]->empty() && !a[1]->empty())
      o = mem_pair(opt, ref, pes, *a[0], *a[1], pair_id, &subo, &n_sub, z);
    if (o > 0) {
      // multiple primary hits on either end -> no pairing
      bool is_multi[2] = {false, false};
      for (int i = 0; i < 2; ++i)
        for (size_t j = 1; j < a[i]->size(); ++j)
          if ((*a[i])[j].secondary < 0 && (*a[i])[j].score >= opt.T) {
            is_multi[i] = true;
            break;
          }
      if (!is_multi[0] && !is_multi[1]) {
        int score_un = (*a[0])[0].score + (*a[1])[0].score - ope.pen_unpaired;
        if (subo < score_un) subo = score_un;
        int q_pe = raw_mapq(o - subo, opt.a);
        if (n_sub > 0)
          q_pe -= static_cast<int>(4.343 * std::log(n_sub + 1.) + .499);
        if (q_pe < 0) q_pe = 0;
        if (q_pe > 60) q_pe = 60;
        int q_se[2];
        if (o > score_un) {  // paired alignment preferred
          Reg* c[2] = {&(*a[0])[z[0]], &(*a[1])[z[1]]};
          for (int i = 0; i < 2; ++i) {
            if (c[i]->secondary >= 0) {
              c[i]->sub = (*a[i])[c[i]->secondary].score;
              c[i]->secondary = -2;
            }
            q_se[i] = approx_mapq_se(opt, *c[i]);
          }
          for (int i = 0; i < 2; ++i)
            if (q_se[i] <= q_pe)
              q_se[i] = q_pe < q_se[i] + 40 ? q_pe : q_se[i] + 40;
          extra_flag |= 2;
          int cap0 = raw_mapq(c[0]->score - c[0]->csub, opt.a);
          int cap1 = raw_mapq(c[1]->score - c[1]->csub, opt.a);
          if (q_se[0] > cap0) q_se[0] = cap0;
          if (q_se[1] > cap1) q_se[1] = cap1;
        } else {
          z[0] = z[1] = 0;
          q_se[0] = approx_mapq_se(opt, (*a[0])[0]);
          q_se[1] = approx_mapq_se(opt, (*a[1])[0]);
        }
        Aln h0, h1;
        if (reg2aln(opt, mat, ref, s0.l_seq, s0.seq, &(*a[0])[z[0]], &h0) <
            0)
          return false;
        h0.mapq = q_se[0];
        h0.flag |= 0x40 | extra_flag;
        if (reg2aln(opt, mat, ref, s1.l_seq, s1.seq, &(*a[1])[z[1]], &h1) <
            0)
          return false;
        h1.mapq = q_se[1];
        h1.flag |= 0x80 | extra_flag;
        aln2sam(ref, s0.name, s0.comment, s0.qual, s0.seq, s0.l_seq, 1,
                std::vector<Aln>{h0}, 0, &h1, rg_id, out);
        *split_pos = out->size();
        aln2sam(ref, s1.name, s1.comment, s1.qual, s1.seq, s1.l_seq, 1,
                std::vector<Aln>{h1}, 0, &h0, rg_id, out);
        return std::strcmp(s0.name, s1.name) == 0;
      }
    }
  }
  // no_pairing path
  Aln h[2];
  for (int i = 0; i < 2; ++i) {
    const Reg* top =
        (!a[i]->empty() && (*a[i])[0].score >= opt.T) ? &(*a[i])[0]
                                                      : nullptr;
    if (reg2aln(opt, mat, ref, s[i]->l_seq, s[i]->seq, top, &h[i]) < 0)
      return false;
  }
  if (!(opt.flag & kMemFNoPairing) && h[0].rid == h[1].rid && h[0].rid >= 0) {
    int64_t dist;
    int d = infer_dir(ref.l_pac, (*a[0])[0].rb, (*a[1])[0].rb, &dist);
    if (!pes[d].failed && pes[d].low <= dist && dist <= pes[d].high)
      extra_flag |= 2;
  }
  if (!reg2sam_se(opt, mat, ref, s0, *a[0], 0x41 | extra_flag, &h[1], rg_id,
                  out))
    return false;
  *split_pos = out->size();
  if (!reg2sam_se(opt, mat, ref, s1, *a[1], 0x81 | extra_flag, &h[0], rg_id,
                  out))
    return false;
  return std::strcmp(s0.name, s1.name) == 0;
}

}  // namespace

extern "C" {

// Finalize a whole single-end chunk.  Regions arrive flattened (SoA);
// strings arrive concatenated with offset arrays (n_reads+1 entries).
// On success returns a malloc'd buffer of concatenated SAM records
// (caller frees with bm_free) and fills out_rec_off (n_reads+1).
// Returns nullptr on any unrecoverable record (caller falls back to
// the Python finalize for the chunk).
char* bm_finalize_se(
    // options
    int32_t a, int32_t b, int32_t o_del, int32_t e_del, int32_t o_ins,
    int32_t e_ins, int32_t w, int32_t T, int32_t flag,
    int32_t min_seed_len, double mask_level, double mapq_coef_len,
    double mapq_coef_fac, const int8_t* mat,
    // reference
    int64_t l_pac, const uint8_t* pac, int32_t n_anns,
    const int64_t* ann_off, const int32_t* ann_len, const char* ann_names,
    // reads
    int32_t n_reads, int64_t n_processed, const uint8_t* seqs,
    const int64_t* seq_off, const char* names, const int64_t* name_off,
    const char* quals, const int64_t* qual_off, const char* comments,
    const int64_t* comm_off, const char* rg_id,
    // regions, flattened
    const int64_t* reg_off, const int64_t* reg_rb, const int64_t* reg_re,
    const int32_t* reg_qb, const int32_t* reg_qe, const int32_t* reg_score,
    const int32_t* reg_truesc, const int32_t* reg_csub,
    const int32_t* reg_w, const int32_t* reg_seedcov,
    // out
    int64_t* out_rec_off, int64_t* out_total_len) {
  Opt opt{a, b, o_del, e_del, o_ins, e_ins, w, T, flag, min_seed_len,
          mask_level, mapq_coef_len, mapq_coef_fac};
  Ref ref;
  ref.l_pac = l_pac;
  ref.pac = pac;
  ref.n_anns = n_anns;
  ref.ann_off = ann_off;
  ref.ann_len = ann_len;
  ref.ann_name.resize(n_anns);
  {
    const char* pn = ann_names;
    for (int i = 0; i < n_anns; ++i) {
      ref.ann_name[i] = pn;
      pn += std::strlen(pn) + 1;
    }
  }

  // reads are independent: parallelize across them, then join the
  // per-read buffers in order (deterministic output regardless of the
  // thread count; BWAMEM_TPU_NATIVE_THREADS caps the team)
  std::vector<std::string> outs(n_reads);
  std::atomic<bool> failed{false};
  bm_parallel_for(n_reads, 16, [&](int r) {
    if (failed.load(std::memory_order_relaxed)) return;
    const uint8_t* seq = seqs + seq_off[r];
    int l_seq = static_cast<int>(seq_off[r + 1] - seq_off[r]);
    const char* name = names + name_off[r];
    const char* qual = quals + qual_off[r];
    const char* comment = comments + comm_off[r];

    std::vector<Reg> regs;
    for (int64_t k = reg_off[r]; k < reg_off[r + 1]; ++k) {
      Reg g;
      g.rb = reg_rb[k];
      g.re = reg_re[k];
      g.qb = reg_qb[k];
      g.qe = reg_qe[k];
      g.score = reg_score[k];
      g.truesc = reg_truesc[k];
      g.sub = 0;
      g.csub = reg_csub[k];
      g.sub_n = 0;
      g.w = reg_w[k];
      g.seedcov = reg_seedcov[k];
      g.secondary = -1;
      g.hash = 0;
      regs.push_back(g);
    }
    mark_primary(opt, regs, n_processed + r);
    ReadView rd{name, comment, qual, seq, l_seq};
    if (!reg2sam_se(opt, mat, ref, rd, regs, 0, nullptr, rg_id,
                    &outs[r]))
      failed.store(true, std::memory_order_relaxed);
  });
  if (failed.load()) return nullptr;
  std::string out;
  out.reserve(static_cast<size_t>(n_reads) * 256);
  for (int r = 0; r < n_reads; ++r) {
    out_rec_off[r] = static_cast<int64_t>(out.size());
    out += outs[r];
  }
  out_rec_off[n_reads] = static_cast<int64_t>(out.size());
  *out_total_len = static_cast<int64_t>(out.size());
  char* buf = static_cast<char*>(std::malloc(out.size() + 1));
  std::memcpy(buf, out.data(), out.size());
  buf[out.size()] = 0;
  return buf;
}

void bm_free(void* p) { std::free(p); }

// Finalize a whole paired-end chunk (reads interleaved; n_reads even).
// Arguments mirror bm_finalize_se plus the insert-size stats (pes) and
// the PE options.  Returns nullptr on any unrecoverable pair (caller
// falls back to the Python finalize for the chunk).
char* bm_finalize_pe(
    // options
    int32_t a, int32_t b, int32_t o_del, int32_t e_del, int32_t o_ins,
    int32_t e_ins, int32_t w, int32_t T, int32_t flag,
    int32_t min_seed_len, double mask_level, double mapq_coef_len,
    double mapq_coef_fac, const int8_t* mat, int32_t pen_unpaired,
    int32_t max_matesw, double mask_level_redun,
    // insert-size stats per orientation FF/FR/RF/RR
    const int64_t* pes_low, const int64_t* pes_high,
    const int32_t* pes_failed, const double* pes_avg,
    const double* pes_std,
    // reference
    int64_t l_pac, const uint8_t* pac, int32_t n_anns,
    const int64_t* ann_off, const int32_t* ann_len, const char* ann_names,
    // reads (interleaved pairs)
    int32_t n_reads, int64_t n_processed, const uint8_t* seqs,
    const int64_t* seq_off, const char* names, const int64_t* name_off,
    const char* quals, const int64_t* qual_off, const char* comments,
    const int64_t* comm_off, const char* rg_id,
    // regions, flattened
    const int64_t* reg_off, const int64_t* reg_rb, const int64_t* reg_re,
    const int32_t* reg_qb, const int32_t* reg_qe, const int32_t* reg_score,
    const int32_t* reg_truesc, const int32_t* reg_csub,
    const int32_t* reg_w, const int32_t* reg_seedcov,
    // out
    int64_t* out_rec_off, int64_t* out_total_len) {
  Opt opt{a, b, o_del, e_del, o_ins, e_ins, w, T, flag, min_seed_len,
          mask_level, mapq_coef_len, mapq_coef_fac};
  OptPe ope{pen_unpaired, max_matesw, mask_level_redun};
  PeStatC pes[4];
  for (int d = 0; d < 4; ++d)
    pes[d] = PeStatC{pes_low[d], pes_high[d], pes_failed[d], pes_avg[d],
                     pes_std[d]};
  Ref ref;
  ref.l_pac = l_pac;
  ref.pac = pac;
  ref.n_anns = n_anns;
  ref.ann_off = ann_off;
  ref.ann_len = ann_len;
  ref.ann_name.resize(n_anns);
  {
    const char* pn = ann_names;
    for (int i = 0; i < n_anns; ++i) {
      ref.ann_name[i] = pn;
      pn += std::strlen(pn) + 1;
    }
  }

  // pairs are independent (pestat was computed chunk-wide upstream):
  // parallelize across pairs, join per-pair buffers in order
  const int n_pairs = n_reads >> 1;
  std::vector<std::string> outs(n_pairs);
  std::vector<size_t> splits(n_pairs, 0);
  std::atomic<bool> failed{false};
  bm_parallel_for(n_pairs, 8, [&](int p) {
    if (failed.load(std::memory_order_relaxed)) return;
    int r = p << 1;
    ReadView rv[2];
    std::vector<Reg> regs[2];
    for (int e = 0; e < 2; ++e) {
      int i = r + e;
      rv[e] = ReadView{names + name_off[i], comments + comm_off[i],
                       quals + qual_off[i], seqs + seq_off[i],
                       static_cast<int>(seq_off[i + 1] - seq_off[i])};
      for (int64_t k = reg_off[i]; k < reg_off[i + 1]; ++k) {
        Reg g;
        g.rb = reg_rb[k];
        g.re = reg_re[k];
        g.qb = reg_qb[k];
        g.qe = reg_qe[k];
        g.score = reg_score[k];
        g.truesc = reg_truesc[k];
        g.sub = 0;
        g.csub = reg_csub[k];
        g.sub_n = 0;
        g.w = reg_w[k];
        g.seedcov = reg_seedcov[k];
        g.secondary = -1;
        g.hash = 0;
        regs[e].push_back(g);
      }
    }
    size_t split = 0;
    int64_t pair_id = (n_processed >> 1) + p;
    if (!sam_pe(opt, ope, mat, ref, pes, pair_id, rv[0], rv[1], &regs[0],
                &regs[1], rg_id, &outs[p], &split))
      failed.store(true, std::memory_order_relaxed);
    splits[p] = split;
  });
  if (failed.load()) return nullptr;
  std::string out;
  out.reserve(static_cast<size_t>(n_reads) * 256);
  for (int p = 0; p < n_pairs; ++p) {
    int r = p << 1;
    out_rec_off[r] = static_cast<int64_t>(out.size());
    out_rec_off[r + 1] = static_cast<int64_t>(out.size() + splits[p]);
    out += outs[p];
  }
  out_rec_off[n_reads] = static_cast<int64_t>(out.size());
  *out_total_len = static_cast<int64_t>(out.size());
  char* buf = static_cast<char*>(std::malloc(out.size() + 1));
  std::memcpy(buf, out.data(), out.size());
  buf[out.size()] = 0;
  return buf;
}

}  // extern "C"
