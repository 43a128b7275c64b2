// Native region construction for bwamem_tpu: chains + (device-computed)
// fused seed-extension results -> deduplicated alignment regions, for a
// whole chunk in one call.
//
// Covers the serial per-read logic of mem_align1_core between chaining
// and finalize (behavioral spec: bwamem_tpu/core/{chain,region,pipeline}.py):
//   mem_chain_flt        weight sort (exact introsort permutation) +
//                        overlap filter
//   mem_chain2aln_short  whole-chain local-SW fast path (native align2)
//   mem_chain2aln        seed-sorted extension with containment checks,
//                        CONSUMING the speculative device wave's results
//                        positionally (one result per flattened seed)
//   mem_sort_and_dedup + mem_test_and_remove_exact
//
// The banded extensions themselves stay on the device (the speculative
// extend_lr wave, ops/engine.py); this code only replays the exact
// serial bookkeeping that decides which results become regions.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

#include "common.h"

extern "C" {
// from ksw.cpp
void bm_ksw_align2(int qlen, const uint8_t* query, int tlen,
                   const uint8_t* target, const int8_t* mat, int o_del,
                   int e_del, int o_ins, int e_ins, int xtra, int32_t* out7);
}

namespace {

using bm::get_seq;
using bm::ks_introsort;

constexpr int kMemShortExt = 50;
constexpr int kMemShortLen = 200;
constexpr int kMemFNoExact = 0x40;

struct Opt {
  int32_t a, b, o_del, e_del, o_ins, e_ins, w, min_seed_len, flag;
  double mask_level, chain_drop_ratio, mask_level_redun;
};

struct Seed {
  int64_t rbeg;
  int32_t qbeg, len;
};

struct RegO {  // region under construction (mirrors core/region.py AlnReg)
  int64_t rb = 0, re = 0;
  int32_t qb = 0, qe = 0, score = 0, truesc = 0, csub = 0, w = 0,
          seedcov = 0;
};

// ---- reference fetch (same semantics as finalize.cpp get_seq) ----

inline int cal_max_gap(const Opt& opt, int qlen) {
  return bm::cal_max_gap(opt.a, opt.o_del, opt.e_del, opt.o_ins,
                         opt.e_ins, opt.w, qlen);
}

// mem_chain_weight (spec: core/chain.py chain_weight, incl. the
// reference's reuse of the query-end in the reference-side pass)
int chain_weight(const std::vector<Seed>& seeds) {
  int64_t w = 0, end = 0;
  for (const Seed& s : seeds) {
    if (s.qbeg >= end)
      w += s.len;
    else if (s.qbeg + s.len > end)
      w += s.qbeg + s.len - end;
    int64_t e = static_cast<int64_t>(s.qbeg) + s.len;
    if (e > end) end = e;
  }
  int64_t tmp = w;
  w = 0;
  end = 0;
  for (const Seed& s : seeds) {
    if (s.rbeg >= end)
      w += s.len;
    else if (s.rbeg + s.len > end)
      w += s.rbeg + s.len - end;
    int64_t e = static_cast<int64_t>(s.qbeg) + s.len;  // sic (bwamem.c:518)
    if (e > end) end = e;
  }
  return static_cast<int>(w < tmp ? w : tmp);
}

struct FltAux {
  int32_t beg, end, w;
  int32_t chain;  // post-sort slot, then resolved to index
  int32_t p2;     // -1 = none
};

// mem_chain_flt (spec: core/chain.py mem_chain_flt).  `order` maps
// output position -> original chain index.
void chain_flt(const Opt& opt, const std::vector<std::vector<Seed>>& chains,
               std::vector<int>* order) {
  int n_chn = static_cast<int>(chains.size());
  order->clear();
  if (n_chn == 0) return;
  if (n_chn == 1) {
    order->push_back(0);
    return;
  }
  struct Entry {
    FltAux a;
    int orig;
  };
  std::vector<Entry> aux(n_chn);
  for (int i = 0; i < n_chn; ++i) {
    const std::vector<Seed>& c = chains[i];
    aux[i].a.beg = c.front().qbeg;
    aux[i].a.end = c.back().qbeg + c.back().len;
    aux[i].a.w = chain_weight(c);
    aux[i].a.p2 = -1;
    aux[i].orig = i;
  }
  ks_introsort(aux, [](const Entry& x, const Entry& y) {
    return x.a.w > y.a.w;  // flt_lt: weight desc
  });
  // slots now refer to the sorted order
  for (int i = 0; i < n_chn; ++i) aux[i].a.chain = i;
  std::vector<int> kept{0};
  for (int i = 1; i < n_chn; ++i) {
    FltAux& ai = aux[i].a;
    size_t j = 0;
    for (; j < kept.size(); ++j) {
      FltAux& aj = aux[kept[j]].a;
      int b_max = aj.beg > ai.beg ? aj.beg : ai.beg;
      int e_min = aj.end < ai.end ? aj.end : ai.end;
      if (e_min > b_max) {  // overlap
        int min_l = ai.end - ai.beg < aj.end - aj.beg ? ai.end - ai.beg
                                                      : aj.end - aj.beg;
        if (e_min - b_max >= min_l * opt.mask_level) {  // significant
          if (aj.p2 < 0) aj.p2 = ai.chain;
          if (ai.w < aj.w * opt.chain_drop_ratio &&
              aj.w - ai.w >= opt.min_seed_len * 2)
            break;
        }
      }
    }
    if (j == kept.size()) kept.push_back(i);
  }
  std::vector<char> keep_idx(n_chn, 0);
  for (int k : kept) {
    keep_idx[aux[k].a.chain] = 1;
    if (aux[k].a.p2 >= 0) keep_idx[aux[k].a.p2] = 1;
  }
  // output order: the weight-sorted order, filtered (chain.py returns
  // [chains[i] for i in range(n) if i in keep_idx] over sorted chains)
  for (int i = 0; i < n_chn; ++i)
    if (keep_idx[i]) order->push_back(aux[i].orig);
}

// mem_chain2aln_short (spec: core/region.py chain2aln_short).
// Returns 0 with *out filled, 1 = run the general path, -1 = skip.
int chain2aln_short(const Opt& opt, const int8_t* mat, int64_t l_pac,
                    const uint8_t* pac, const uint8_t* query, int l_query,
                    const std::vector<Seed>& seeds, RegO* out) {
  if (seeds.empty()) return -1;
  int64_t qb = l_query, qe = 0;
  int64_t rb = l_pac << 1, re = 0;
  int seedcov = 0;
  for (const Seed& s : seeds) {
    if (s.qbeg < qb) qb = s.qbeg;
    if (s.qbeg + s.len > qe) qe = s.qbeg + s.len;
    if (s.rbeg < rb) rb = s.rbeg;
    if (s.rbeg + s.len > re) re = s.rbeg + s.len;
    seedcov += s.len;
  }
  qb -= kMemShortExt;
  qe += kMemShortExt;
  if (qb <= 10 || qe >= l_query - 10) return 1;
  rb -= kMemShortExt;
  re += kMemShortExt;
  if (rb < 0) rb = 0;
  if (re > l_pac << 1) re = l_pac << 1;
  if (rb < l_pac && l_pac < re) {
    if (seeds.front().rbeg < l_pac)
      re = l_pac;
    else
      rb = l_pac;
  }
  if ((re - rb) - (qe - qb) > kMemShortExt ||
      (qe - qb) - (re - rb) > kMemShortExt)
    return 1;
  if (qe - qb >= opt.w * 4 || re - rb >= opt.w * 4) return 1;
  if (qe - qb >= kMemShortLen || re - rb >= kMemShortLen) return 1;

  std::vector<uint8_t> rseq = get_seq(l_pac, pac, rb, re);
  int xtra = 0x40000 /*XSUBO*/ | 0x80000 /*XSTART*/ |
             (((qe - qb) * opt.a < 250) ? 0x10000 /*XBYTE*/ : 0) |
             (opt.min_seed_len * opt.a);
  int32_t o7[7];
  bm_ksw_align2(static_cast<int>(qe - qb), query + qb,
                static_cast<int>(rseq.size()), rseq.data(), mat, opt.o_del,
                opt.e_del, opt.o_ins, opt.e_ins, xtra, o7);
  // o7 = {score, te, qe, score2, te2, tb, qb}
  if (o7[5] < (kMemShortExt >> 1) ||
      o7[1] > re - rb - (kMemShortExt >> 1))
    return 1;
  out->seedcov = seedcov;
  out->rb = rb + o7[5];
  out->re = rb + o7[1] + 1;
  out->qb = static_cast<int32_t>(qb) + o7[6];
  out->qe = static_cast<int32_t>(qb) + o7[2] + 1;
  out->score = o7[0];
  out->csub = o7[3];
  out->truesc = 0;
  out->w = 0;
  return 0;
}

// mem_sort_and_dedup (spec: core/region.py sort_and_dedup)
void sort_and_dedup(std::vector<RegO>& regs, double mask_level_redun) {
  if (regs.size() <= 1) return;
  ks_introsort(regs, [](const RegO& a, const RegO& b) {  // mem_ars2
    return a.re < b.re;
  });
  for (int i = 1; i < static_cast<int>(regs.size()); ++i) {
    RegO& p = regs[i];
    if (p.rb >= regs[i - 1].re) continue;
    int j = i - 1;
    while (j >= 0 && p.rb < regs[j].re) {
      RegO& q = regs[j];
      --j;
      if (q.qe == q.qb) continue;
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
    std::vector<RegO> kept;
    for (const RegO& r : regs)
      if (r.qe > r.qb) kept.push_back(r);
    regs.swap(kept);
  }
  ks_introsort(regs, [](const RegO& a, const RegO& b) {  // mem_ars
    return a.score > b.score ||
           (a.score == b.score &&
            (a.rb < b.rb || (a.rb == b.rb && a.qb < b.qb)));
  });
  for (size_t i = 1; i < regs.size(); ++i)
    if (regs[i].score == regs[i - 1].score && regs[i].rb == regs[i - 1].rb &&
        regs[i].qb == regs[i - 1].qb)
      regs[i].qe = regs[i].qb;
  if (!regs.empty()) {
    std::vector<RegO> out{regs[0]};
    for (size_t i = 1; i < regs.size(); ++i)
      if (regs[i].qe > regs[i].qb) out.push_back(regs[i]);
    regs.swap(out);
  }
}

// one extension result from the speculative device wave, positionally
// aligned with the flattened (read, chain, seed) order
struct ExtRes {
  int32_t score, truesc, qb, qe, aw0, aw1;
  int64_t rb, re;
};

// mem_chain2aln consuming cached extension results
// (spec: core/region.py chain2aln_gen, trace=None branch)
void chain2aln_cached(const Opt& opt, const std::vector<Seed>& seeds,
                      const ExtRes* ext, std::vector<RegO>* av) {
  int n = static_cast<int>(seeds.size());
  if (n == 0) return;
  std::vector<uint64_t> srt(n);
  for (int i = 0; i < n; ++i)
    srt[i] = (static_cast<uint64_t>(seeds[i].len) << 32) |
             static_cast<uint32_t>(i);
  std::sort(srt.begin(), srt.end());

  for (int k = n - 1; k >= 0; --k) {
    int sid = static_cast<int>(srt[k] & 0xFFFFFFFFull);
    const Seed& s = seeds[sid];

    // skip seeds contained in an existing region (bwamem.c:1079-1112)
    int hit = -1;
    for (size_t i = 0; i < av->size(); ++i) {
      const RegO& p = (*av)[i];
      if (s.rbeg < p.rb || s.rbeg + s.len > p.re || s.qbeg < p.qb ||
          s.qbeg + s.len > p.qe)
        continue;
      int64_t qd = s.qbeg - p.qb, rd = s.rbeg - p.rb;
      int w = cal_max_gap(opt, static_cast<int>(qd < rd ? qd : rd));
      if (w > opt.w) w = opt.w;
      if (qd - rd < w && rd - qd < w) {
        hit = static_cast<int>(i);
        break;
      }
      qd = p.qe - (s.qbeg + s.len);
      rd = p.re - (s.rbeg + s.len);
      w = cal_max_gap(opt, static_cast<int>(qd < rd ? qd : rd));
      if (w > opt.w) w = opt.w;
      if (qd - rd < w && rd - qd < w) {
        hit = static_cast<int>(i);
        break;
      }
    }
    if (hit >= 0) {
      // confirm no overlapping seed would produce a different alignment
      int i = k + 1;
      for (; i < n; ++i) {
        if (srt[i] == 0) continue;
        const Seed& t = seeds[static_cast<int>(srt[i] & 0xFFFFFFFFull)];
        if (t.len < s.len * .95) continue;
        if (s.qbeg <= t.qbeg && s.qbeg + s.len - t.qbeg >= (s.len >> 2) &&
            t.qbeg - s.qbeg != t.rbeg - s.rbeg)
          break;
        if (t.qbeg <= s.qbeg && t.qbeg + t.len - s.qbeg >= (s.len >> 2) &&
            s.qbeg - t.qbeg != s.rbeg - t.rbeg)
          break;
      }
      if (i == n) {
        srt[k] = 0;  // mark extension not performed
        continue;
      }
    }

    const ExtRes& e = ext[sid];
    RegO a;
    a.score = e.score;
    a.truesc = e.truesc;
    a.qb = e.qb;
    a.rb = e.rb;
    a.qe = e.qe;
    a.re = e.re;
    a.csub = 0;
    a.seedcov = 0;
    for (const Seed& t : seeds)
      if (t.qbeg >= a.qb && t.qbeg + t.len <= a.qe && t.rbeg >= a.rb &&
          t.rbeg + t.len <= a.re)
        a.seedcov += t.len;
    a.w = e.aw0 > e.aw1 ? e.aw0 : e.aw1;
    av->push_back(a);
  }
}

}  // namespace

extern "C" {

// Build every read's deduplicated region list from chains + the
// speculative extension wave's per-seed results.  Seeds arrive
// flattened in (read, chain, seed) order with chain_off (per read) and
// seed_off (per chain) offset arrays; ext_* are positionally aligned
// with the flattened seeds.  Outputs flattened regions (SoA) capped at
// `out_cap`; returns total regions, or -1 when out_cap is too small.
int64_t bm_regions_batch(
    // options
    int32_t a, int32_t b, int32_t o_del, int32_t e_del, int32_t o_ins,
    int32_t e_ins, int32_t w, int32_t min_seed_len, int32_t flag,
    double mask_level, double chain_drop_ratio, double mask_level_redun,
    const int8_t* mat,
    // reference
    int64_t l_pac, const uint8_t* pac,
    // reads
    int32_t n_reads, const uint8_t* seqs, const int64_t* seq_off,
    // chains + seeds, flattened
    const int64_t* chain_off,  // n_reads+1, into seed_off index space
    const int64_t* seed_off,   // n_chains_total+1, into seed arrays
    const int64_t* seed_rbeg, const int32_t* seed_qbeg,
    const int32_t* seed_len,
    // per-seed extension results (positional)
    const int32_t* ext_score, const int32_t* ext_truesc,
    const int32_t* ext_qb, const int64_t* ext_rb, const int32_t* ext_qe,
    const int64_t* ext_re, const int32_t* ext_aw0, const int32_t* ext_aw1,
    // out (flattened regions)
    int64_t out_cap, int64_t* out_reg_off, int64_t* out_rb,
    int64_t* out_re, int32_t* out_qb, int32_t* out_qe, int32_t* out_score,
    int32_t* out_truesc, int32_t* out_csub, int32_t* out_w,
    int32_t* out_seedcov) {
  Opt opt{a,           b,          o_del,        e_del,
          o_ins,       e_ins,      w,            min_seed_len,
          flag,        mask_level, chain_drop_ratio, mask_level_redun};
  std::vector<std::vector<RegO>> per_read(n_reads);
  bm_parallel_for(n_reads, 16, [&](int r) {
    const uint8_t* query = seqs + seq_off[r];
    int l_query = static_cast<int>(seq_off[r + 1] - seq_off[r]);

    // collect this read's chains
    std::vector<std::vector<Seed>> chains;
    std::vector<int64_t> ext_base;  // flat seed base per chain
    for (int64_t c = chain_off[r]; c < chain_off[r + 1]; ++c) {
      std::vector<Seed> seeds;
      for (int64_t k = seed_off[c]; k < seed_off[c + 1]; ++k)
        seeds.push_back(Seed{seed_rbeg[k], seed_qbeg[k], seed_len[k]});
      chains.push_back(std::move(seeds));
      ext_base.push_back(seed_off[c]);
    }

    std::vector<int> order;
    chain_flt(opt, chains, &order);

    std::vector<RegO> av;
    std::vector<ExtRes> ext;
    for (int ci : order) {
      const std::vector<Seed>& seeds = chains[ci];
      RegO shortr;
      int st = chain2aln_short(opt, mat, l_pac, pac, query, l_query, seeds,
                               &shortr);
      if (st == 0) {
        av.push_back(shortr);
      } else if (st > 0) {
        ext.clear();
        int64_t base = ext_base[ci];
        for (size_t si = 0; si < seeds.size(); ++si) {
          int64_t k = base + static_cast<int64_t>(si);
          ext.push_back(ExtRes{ext_score[k], ext_truesc[k], ext_qb[k],
                               ext_qe[k], ext_aw0[k], ext_aw1[k],
                               ext_rb[k], ext_re[k]});
        }
        chain2aln_cached(opt, seeds, ext.data(), &av);
      }
    }
    sort_and_dedup(av, opt.mask_level_redun);
    if ((opt.flag & kMemFNoExact) && !av.empty() &&
        av[0].truesc == static_cast<int64_t>(l_query) * opt.a)
      av.erase(av.begin());
    per_read[r] = std::move(av);
  });
  int64_t n_out = 0;
  for (int r = 0; r < n_reads; ++r) {
    out_reg_off[r] = n_out;
    if (n_out + static_cast<int64_t>(per_read[r].size()) > out_cap)
      return -1;
    for (const RegO& g : per_read[r]) {
      out_rb[n_out] = g.rb;
      out_re[n_out] = g.re;
      out_qb[n_out] = g.qb;
      out_qe[n_out] = g.qe;
      out_score[n_out] = g.score;
      out_truesc[n_out] = g.truesc;
      out_csub[n_out] = g.csub;
      out_w[n_out] = g.w;
      out_seedcov[n_out] = g.seedcov;
      ++n_out;
    }
  }
  out_reg_off[n_reads] = n_out;
  return n_out;
}

}  // extern "C"
