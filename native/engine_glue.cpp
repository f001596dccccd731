// Native host glue for the batched realignment engine.
//
// Replaces the per-read Python hot loops of align/engine.py's
// _finish_batch (chain-hit extraction, the get_ksw_score walk in
// collect+replay form, CIGAR reverse-merge, result ranking) with a C++
// pass over the packed device outputs. Semantics are a line-for-line
// transcription of align/host_align.py (KswHandler, _score_chain,
// reverse_merge_cigar, align_read result ranking), which itself pins
// the reference behavior of src/PanSVgenerateVCF/read_realignment.cpp
// get_ksw_score (:306-400) + KSW_ALN_handler (:803-990) + sort_output.
//
// Protocol (driven from align/native_glue.py):
//   ctx = glue_collect(...)         walk every kept chain; DP segments
//                                   become request records
//   glue_req_sizes(ctx, ...)        expose (qlen, tlen) per request so
//                                   Python can bucket into device size
//                                   classes
//   glue_fill_dp(ctx, members, ...) write padded int32 code matrices
//                                   for one class chunk
//   glue_set_dp_chunk(ctx, ...)     hand back one chunk's device
//                                   results (raw backward op rows)
//   glue_set_dp_scalar(ctx, ...)    hand back one oversize request's
//                                   scalar-DP result as cigar runs
//   glue_replay(ctx)                second walk pass: final scores,
//                                   cigars, ranking
//   glue_out_sizes / glue_copy_out  fetch results
//   glue_free(ctx)
//
// All scoring constants mirror host_align.py:34-50 (MIN_CHAIN_SCORE 20,
// MAX_CHAIN_SCORE_DIFF 30, MIN_CHAIN_SCORE_LOOP 30, MIN_ALN_SCORE 40,
// MAX_OUTPUT_NUMBER 6; reference read_realignment.cpp:396-398).

#include <algorithm>
#include <array>
#include <atomic>
#include <cctype>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <map>
#include <set>
#include <string>
#include <thread>
#include <cmath>
#include <unordered_map>
#include <vector>

namespace {

constexpr int32_t NEG_INF = -0x40000000;  // ksw2_ref.NEG_INF
constexpr int MIN_CHAIN_SCORE = 20;
constexpr int MAX_CHAIN_SCORE_DIFF = 30;
constexpr int MIN_CHAIN_SCORE_LOOP = 30;
constexpr int MIN_ALN_SCORE = 40;
constexpr int N_HIT = 6;
constexpr int TYPE_LEFT = 0, TYPE_RIGHT = 1, TYPE_END2END = 2;

struct Params {
  int match, mismatch, gap_open, gap_ex, gap_open2, gap_ex2;
};

struct Run {
  uint8_t op;   // 0=M 1=I 2=D
  int32_t n;    // may be negative (folded deletion marker)
};

struct DpReq {
  int32_t read;      // read index (codes row)
  uint8_t dir;       // 0 fwd, 1 rev
  uint8_t type;      // TYPE_*
  int32_t read_st;   // query start in read coords (pre-reversal)
  int32_t qlen;      // nominal query length
  int32_t qlen_act;  // clamped to read end
  int64_t ref_st;    // target start (may be < 0; _ref clamps)
  int32_t tlen;
  // response
  int32_t score = NEG_INF, mqe = NEG_INF;
  uint8_t zdropped = 0;
  std::vector<Run> cigar;
};

struct Chain {
  int32_t read;
  uint8_t dir;
  int32_t chain_score;
  int32_t node;      // hit end node (sort tie-break key)
  int32_t read_bg;
  int32_t chr_id;
  int64_t ref_bg;    // ref_begin0 - chr_starts[chr_id]
  // path mode (glue_collect_paths): the walk's node sequence comes
  // pre-gathered from the device instead of pre-pointer chasing
  int32_t path_off = -1;
  int32_t plen = 0;
  // collect pass records the DP requests this chain creates, in walk
  // order; the replay pass re-executes the identical control flow
  // (segment boundaries and the simple/DP decision never depend on a DP
  // outcome) and consumes them sequentially
  std::vector<int32_t> req_ids;
  // replay results
  int32_t rba = 0;            // read_begin_alignment
  int32_t align_score = 0;
  std::vector<Run> cigar;
  bool cigar_ok = false;
};

struct ReadOut {
  int32_t read;
  std::vector<int32_t> chain_ids;  // into ctx->chains, walk order
  int32_t max_chain_score;
};

struct Ctx {
  Params p;
  int32_t n_pad, L, K;
  const int16_t *s_rb, *s_re, *s_dfe;
  const int32_t *s_fb;
  const int8_t *pre;
  // path mode: device-compacted node arrays (ops/collect.py layout)
  const int32_t *path_a = nullptr;   // rb | re<<16
  const int32_t *path_b = nullptr;   // fb
  const int16_t *path_dfe = nullptr; // fe - fb
  const uint8_t *codes_f, *codes_r;
  const int32_t *lens;
  const uint8_t *packed_ref;
  int64_t ref_len;
  const int64_t *chr_starts;
  int32_t n_chr;
  const int32_t *sv_st_pos;

  std::vector<DpReq> reqs;
  std::vector<Chain> chains;
  std::vector<ReadOut> reads;

  // outputs (filled by glue_replay)
  std::vector<int32_t> res_read;
  std::vector<int32_t> res_fields;  // 8 per result
  std::vector<uint8_t> out_cig_op;
  std::vector<int32_t> out_cig_len;
  std::vector<int32_t> res_cig_off, res_cig_n;

  // filled by glue_pe_emit: encoded BAM record bodies for the batch
  std::vector<uint8_t> emit_buf;
};

// ---- KswHandler state for one walk --------------------------------------

struct Walk {
  Ctx* ctx;
  Chain* ch;
  const uint8_t* read;  // codes row
  int32_t read_l;
  int32_t read_score = 0;
  int32_t total_q_len = 0;
  bool is_simple = false;
  bool collect;  // true = pass 1 (create requests), false = pass 2
  size_t req_cursor;  // pass 2: next token index consuming DP results

  void push(uint8_t op, int32_t n) {
    if (!collect) ch->cigar.push_back({op, n});
  }

  // _ref(st, ln): clamp start to 0, zero-pad past the end
  inline uint8_t ref_at(int64_t st, int32_t i) const {
    int64_t pos = (st < 0 ? 0 : st) + i;
    return pos < ctx->ref_len ? ctx->packed_ref[pos] : 0;
  }

  int get_mismatch(int32_t read_st, int32_t read_ed, int64_t ref_st,
                   int64_t ref_ed) {
    int32_t qlen = read_ed - read_st;
    int32_t tlen = (int32_t)(ref_ed - ref_st);
    if (ref_ed < ref_st) {
      qlen += (int32_t)(ref_st - ref_ed);
      tlen = 0;
    }
    int32_t q_act = std::min(qlen, read_l - read_st);
    if (q_act < 0) q_act = 0;
    int32_t n = std::min(q_act, tlen);
    int nm = 0;
    for (int32_t i = 0; i < n; i++)
      if (read[read_st + i] != ref_at(ref_st, i)) nm++;
    nm += q_act - n;
    return nm < 3 ? nm : 3;  // cap (cpp:921)
  }

  void alignment(int32_t read_st, int32_t read_ed, int64_t ref_st,
                 int64_t ref_ed, uint8_t type) {
    const Params& p = ctx->p;
    int32_t qlen = read_ed - read_st;
    int32_t tlen = (int32_t)(ref_ed - ref_st);
    if (ref_ed < ref_st) {
      qlen += (int32_t)(ref_st - ref_ed);
      tlen = 0;
    }
    int32_t q_act = std::min(qlen, read_l - read_st);
    if (q_act < 0) q_act = 0;
    total_q_len += qlen;

    // simple-compare fast path (cpp:945-955). LEFT reverses both
    // sequences BEFORE the compare (KswHandler.alignment:151-153), so
    // its element i is read[read_st + q_act-1-i] vs ref[tlen-1-i] — the
    // compare runs from the tail ends, not the fronts.
    is_simple = false;
    int simple_nm = 0;
    if (qlen == 0 || tlen == 0) {
      is_simple = true;
      simple_nm = qlen + tlen;
    } else if (qlen == tlen || type != TYPE_END2END) {
      int32_t n = std::min(qlen, tlen);
      int32_t n2 = std::min(n, q_act);
      int nm = 0;
      if (type == TYPE_LEFT) {
        for (int32_t i = 0; i < n2 && nm < 6; i++)
          if (read[read_st + q_act - 1 - i] !=
              ref_at(ref_st, tlen - 1 - i))
            nm++;
      } else {
        for (int32_t i = 0; i < n2 && nm < 6; i++)
          if (read[read_st + i] != ref_at(ref_st, i)) nm++;
      }
      simple_nm = nm < 6 ? nm : 6;
      if (simple_nm == 1 || (simple_nm < 6 && (simple_nm << 3) < qlen))
        is_simple = true;
    }

    if (is_simple) {
      if (qlen == 0 || tlen == 0) {
        if (simple_nm != 0) {
          int s1 = p.gap_open + (simple_nm - 1) * p.gap_ex;
          int s2 = p.gap_open2 + (simple_nm - 1) * p.gap_ex2;
          read_score -= std::min(s1, s2);
        }
      } else {
        read_score += qlen * p.match - simple_nm * (p.match + p.mismatch);
      }
      if (qlen == 0)
        push(2, tlen);
      else if (tlen == 0)
        push(1, qlen);
      else
        push(0, qlen);
      if (ref_ed < ref_st) push(2, (int32_t)(ref_ed - ref_st));
      return;
    }

    if ((int64_t)qlen * tlen > 1000000) {
      push(1, qlen);
      push(2, tlen);  // dummy, score 0 (cpp:895-907)
      return;
    }

    if (collect) {
      DpReq r;
      r.read = ch->read;
      r.dir = ch->dir;
      r.type = type;
      r.read_st = read_st;
      r.qlen = qlen;
      r.qlen_act = q_act;
      r.ref_st = ref_st;
      r.tlen = tlen;
      ctx->reqs.push_back(std::move(r));
      ch->req_ids.push_back((int32_t)ctx->reqs.size() - 1);
    } else {
      // replay: consume the next DP response in walk order
      const DpReq& r = ctx->reqs[ch->req_ids[req_cursor++]];
      if (type == TYPE_END2END) {
        read_score += (r.score != NEG_INF ? r.score : 0);
        for (auto it = r.cigar.rbegin(); it != r.cigar.rend(); ++it)
          ch->cigar.push_back(*it);
      } else if (type == TYPE_LEFT) {
        read_score += (r.mqe != NEG_INF ? r.mqe : 0);
        for (const Run& rn : r.cigar) ch->cigar.push_back(rn);
      } else {
        read_score += (r.mqe != NEG_INF ? r.mqe : 0);
        for (auto it = r.cigar.rbegin(); it != r.cigar.rend(); ++it)
          ch->cigar.push_back(*it);
      }
    }
  }
};

// the get_ksw_score walk (_score_chain); collect pass creates DP
// requests + tokens, replay pass rebuilds cigar + score from responses
static void score_chain(Ctx* ctx, Chain* ch, bool collect) {
  const Params& p = ctx->p;
  const bool path_mode = ch->path_off >= 0;
  const int32_t K = ctx->K;
  const int32_t row =
      ch->dir == 0 ? ch->read : ch->read + ctx->n_pad;
  const int16_t* rb = path_mode ? nullptr : ctx->s_rb + (int64_t)row * K;
  const int16_t* re = path_mode ? nullptr : ctx->s_re + (int64_t)row * K;
  const int32_t* fb = path_mode ? nullptr : ctx->s_fb + (int64_t)row * K;
  const int16_t* dfe = path_mode ? nullptr : ctx->s_dfe + (int64_t)row * K;
  const int8_t* pre = path_mode ? nullptr : ctx->pre + (int64_t)row * K;

  Walk w;
  w.ctx = ctx;
  w.ch = ch;
  w.read = (ch->dir == 0 ? ctx->codes_f : ctx->codes_r) +
           (int64_t)ch->read * ctx->L;
  w.read_l = ctx->lens[ch->read];
  w.collect = collect;
  w.req_cursor = 0;
  if (!collect) {
    ch->cigar.clear();
  }

  const int32_t read_l = w.read_l;
  const int64_t MAXI = 0x7FFFFFFF;
  int32_t aln_read_begin = read_l;
  int32_t aln_read_end = read_l;
  int64_t aln_ref_begin = MAXI;
  int64_t aln_ref_end = MAXI;
  int32_t last_aln_begin = read_l;
  int64_t last_ref_begin = MAXI;
  int unitig_mis = 0;

  int32_t node = ch->node;
  int32_t step = 0;
  while (true) {
    int32_t mem_read_beg, mem_read_end;
    int64_t mem_ref_beg, mem_ref_end;
    if (path_mode) {
      int32_t a = ctx->path_a[ch->path_off + step];
      mem_read_beg = a & 0xFFFF;
      mem_read_end = a >> 16;
      mem_ref_beg = ctx->path_b[ch->path_off + step];
      mem_ref_end = mem_ref_beg + ctx->path_dfe[ch->path_off + step];
    } else {
      mem_read_beg = rb[node];
      mem_read_end = re[node];
      mem_ref_beg = fb[node];
      mem_ref_end = (int64_t)fb[node] + dfe[node];
    }

    aln_read_begin = std::min(aln_read_begin, mem_read_end);
    aln_ref_begin = std::min(aln_ref_begin, mem_ref_end);
    if (aln_read_begin <= aln_read_end) {
      if (aln_read_end < last_aln_begin) {
        int32_t mem_len = last_aln_begin - aln_read_end;
        unitig_mis += w.get_mismatch(aln_read_end, aln_read_end + mem_len,
                                     last_ref_begin,
                                     last_ref_begin + mem_len);
        w.push(0, mem_len);
      }
      last_aln_begin = aln_read_begin;
      uint8_t ty;
      int64_t use_ref_end = aln_ref_end;
      if (aln_ref_end == MAXI) {
        use_ref_end = aln_ref_begin + (aln_read_end - aln_read_begin) + 30;
        ty = TYPE_RIGHT;
      } else {
        ty = TYPE_END2END;
      }
      w.alignment(aln_read_begin, aln_read_end, aln_ref_begin, use_ref_end,
                  ty);
    } else {
      int32_t d_read = aln_read_end - aln_read_begin;
      int64_t d_ref = aln_ref_end - aln_ref_begin;
      if (d_read != d_ref) {
        int64_t dl = d_ref - d_read;
        if (dl < 0) dl = -dl;
        int64_t s1 = p.gap_open + (dl - 1) * p.gap_ex;
        int64_t s2 = p.gap_open2 + (dl - 1) * p.gap_ex2;
        w.read_score -= (int32_t)std::min(s1, s2);
      }
    }
    aln_read_end = mem_read_beg;
    last_ref_begin = mem_ref_beg;
    aln_ref_end = mem_ref_beg;
    if (path_mode) {
      if (++step >= ch->plen) break;
    } else {
      int32_t nxt = pre[node];
      if (nxt == -1) break;
      node = nxt;
    }
  }

  if (aln_read_end < last_aln_begin) {
    int32_t mem_len = last_aln_begin - aln_read_end;
    unitig_mis += w.get_mismatch(aln_read_end, aln_read_end + mem_len,
                                 last_ref_begin, last_ref_begin + mem_len);
    w.push(0, mem_len);
  }

  int32_t read_begin_alignment = 0;
  if (0 < aln_read_end) {
    int64_t ref_begin = aln_ref_end - aln_read_end - 30;
    if (ref_begin < 0) ref_begin = 0;
    w.alignment(0, aln_read_end, ref_begin, aln_ref_end, TYPE_LEFT);
    if (aln_ref_end > ref_begin) {
      if (w.is_simple)
        read_begin_alignment = (int32_t)(aln_ref_end - ref_begin - 30);
      else
        read_begin_alignment = (int32_t)(aln_ref_end - ref_begin);
    }
  }
  w.read_score += (read_l - w.total_q_len) * p.match;
  w.read_score -= unitig_mis * (p.match + p.mismatch);

  if (!collect) {
    ch->rba = read_begin_alignment;
    ch->align_score = w.read_score;
  }
}

// reverse_merge_cigar (host_align.py:223-252; reverseGIGAR hpp:277-301)
static bool reverse_merge(const std::vector<Run>& tmp, int32_t read_len,
                          std::vector<Run>* out) {
  out->clear();
  if (tmp.empty()) return false;
  out->push_back(tmp.back());
  for (size_t k = tmp.size() - 1; k-- > 0;) {
    const Run& r = tmp[k];
    Run& top = out->back();
    if (r.n < 0) {
      // negative deletion folds into previous (try_merge)
      if (top.op == 0) {
        top.n += r.n;
        if (top.n <= 0) return false;
      } else if (top.op == 2) {
        top.n -= r.n;
      } else {
        return false;
      }
    } else if (top.op == r.op || r.n == 0) {
      top.n += r.n;
    } else {
      out->push_back(r);
    }
  }
  if (!out->empty() && (*out)[0].n == 0) out->erase(out->begin());
  int64_t total = 0;
  for (const Run& r : *out)
    if (r.op == 0 || r.op == 1) total += r.n;  // M, I (no N/S here)
  return total == read_len;
}

}  // namespace

extern "C" {

void* glue_collect(
    int32_t n_pad, int32_t L, int32_t K,
    const int16_t* s_rb, const int16_t* s_re, const int32_t* s_fb,
    const int16_t* s_dfe, const int8_t* pre, const int8_t* hit_idx,
    const int16_t* hit_score, const int8_t* hit_final,
    const uint8_t* codes_f, const uint8_t* codes_r, const int32_t* lens,
    const uint8_t* active, const uint8_t* packed_ref, int64_t ref_len,
    const int64_t* chr_starts, int32_t n_chr, const int32_t* sv_st_pos,
    int32_t match, int32_t mismatch, int32_t gap_open, int32_t gap_ex,
    int32_t gap_open2, int32_t gap_ex2, int32_t* n_req_out) {
  Ctx* ctx = new Ctx();
  ctx->p = {match, mismatch, gap_open, gap_ex, gap_open2, gap_ex2};
  ctx->n_pad = n_pad;
  ctx->L = L;
  ctx->K = K;
  ctx->s_rb = s_rb;
  ctx->s_re = s_re;
  ctx->s_fb = s_fb;
  ctx->s_dfe = s_dfe;
  ctx->pre = pre;
  ctx->codes_f = codes_f;
  ctx->codes_r = codes_r;
  ctx->lens = lens;
  ctx->packed_ref = packed_ref;
  ctx->ref_len = ref_len;
  ctx->chr_starts = chr_starts;
  ctx->n_chr = n_chr;
  ctx->sv_st_pos = sv_st_pos;

  for (int32_t i = 0; i < n_pad; i++) {
    if (!active[i]) continue;
    // ---- per-read chain-hit extraction (engine._finish_batch loop) ----
    std::vector<Chain> results;
    int32_t max_chain_score = 0;
    for (int d = 0; d < 2; d++) {
      int32_t row = d == 0 ? i : i + n_pad;
      const int8_t* hidx = hit_idx + (int64_t)row * N_HIT;
      const int16_t* hsc = hit_score + (int64_t)row * N_HIT;
      const int8_t* hfin = hit_final + (int64_t)row * N_HIT;
      if (hidx[0] < 0) continue;
      for (int s = 0; s < N_HIT; s++) {
        int32_t hi = hidx[s];
        if (hi < 0) break;
        int32_t cs = hsc[s];
        if (cs > max_chain_score) max_chain_score = cs;
        if (cs + MAX_CHAIN_SCORE_DIFF < max_chain_score ||
            cs < MIN_CHAIN_SCORE_LOOP)
          break;
        int32_t fin = hfin[s];
        int64_t ref_begin0 = ctx->s_fb[(int64_t)row * K + fin];
        // chr_of_pos: searchsorted(chr_starts, pos, 'right') - 1
        int32_t cid =
            (int32_t)(std::upper_bound(chr_starts, chr_starts + n_chr + 1,
                                       ref_begin0) -
                      chr_starts) -
            1;
        Chain c;
        c.read = i;
        c.dir = (uint8_t)d;
        c.chain_score = cs;
        c.node = hi;
        c.read_bg = ctx->s_rb[(int64_t)row * K + fin];
        c.chr_id = cid;
        c.ref_bg = ref_begin0 - chr_starts[cid];
        results.push_back(std::move(c));
      }
    }
    if (results.empty() || max_chain_score < MIN_CHAIN_SCORE) continue;
    // stable sort by (-chain_score, node)
    std::stable_sort(results.begin(), results.end(),
                     [](const Chain& a, const Chain& b) {
                       if (a.chain_score != b.chain_score)
                         return a.chain_score > b.chain_score;
                       return a.node < b.node;
                     });
    ReadOut ro;
    ro.read = i;
    ro.max_chain_score = max_chain_score;
    for (Chain& c : results) {
      if (c.chain_score + MAX_CHAIN_SCORE_DIFF < max_chain_score) break;
      ctx->chains.push_back(std::move(c));
      int32_t cid = (int32_t)ctx->chains.size() - 1;
      ro.chain_ids.push_back(cid);
      score_chain(ctx, &ctx->chains[cid], /*collect=*/true);
    }
    if (!ro.chain_ids.empty()) ctx->reads.push_back(std::move(ro));
  }
  *n_req_out = (int32_t)ctx->reqs.size();
  return ctx;
}

// Path-mode collect: the per-read chain selection and the pre-pointer
// path gather already ran ON DEVICE (pansvr_tpu/ops/collect.py
// select_and_paths, same break/sort semantics as the loop above); this
// entry consumes the compacted chain/path lanes — the full (rows, K)
// chain tensors never cross the link. chain_meta lanes are read-major;
// bit 24 of meta0 marks a host-fallback read's chain (skip the walk but
// advance the path cursor by its plen).
void* glue_collect_paths(
    int32_t n_pad, int32_t L, const int32_t* chain_meta, int32_t n_lanes,
    const int32_t* path_a, const int32_t* path_b, const int16_t* path_dfe,
    const uint8_t* codes_f, const uint8_t* codes_r, const int32_t* lens,
    const uint8_t* packed_ref, int64_t ref_len, const int64_t* chr_starts,
    int32_t n_chr, const int32_t* sv_st_pos, int32_t match,
    int32_t mismatch, int32_t gap_open, int32_t gap_ex, int32_t gap_open2,
    int32_t gap_ex2, int32_t* n_req_out) {
  Ctx* ctx = new Ctx();
  ctx->p = {match, mismatch, gap_open, gap_ex, gap_open2, gap_ex2};
  ctx->n_pad = n_pad;
  ctx->L = L;
  ctx->K = 0;
  ctx->s_rb = nullptr;
  ctx->s_re = nullptr;
  ctx->s_fb = nullptr;
  ctx->s_dfe = nullptr;
  ctx->pre = nullptr;
  ctx->path_a = path_a;
  ctx->path_b = path_b;
  ctx->path_dfe = path_dfe;
  ctx->codes_f = codes_f;
  ctx->codes_r = codes_r;
  ctx->lens = lens;
  ctx->packed_ref = packed_ref;
  ctx->ref_len = ref_len;
  ctx->chr_starts = chr_starts;
  ctx->n_chr = n_chr;
  ctx->sv_st_pos = sv_st_pos;

  int64_t cursor = 0;
  int32_t cur_read = -1;
  ReadOut ro;
  ro.read = -1;
  for (int32_t lane = 0; lane < n_lanes; lane++) {
    int32_t m0 = chain_meta[(int64_t)lane * 3];
    if (m0 < 0) continue;  // unused lane (plen 0, no cursor advance)
    int32_t plen = (m0 >> 16) & 0xFF;
    int64_t off = cursor;
    cursor += plen;
    if (m0 & (1 << 24)) continue;  // over-budget read: host fallback
    if (plen == 0) continue;       // defensive: no nodes, no walk
    int32_t read = m0 & 0x7FFF;
    int32_t m1 = chain_meta[(int64_t)lane * 3 + 1];
    int64_t ref_begin0 = chain_meta[(int64_t)lane * 3 + 2];
    int32_t cid =
        (int32_t)(std::upper_bound(chr_starts, chr_starts + n_chr + 1,
                                   ref_begin0) -
                  chr_starts) -
        1;
    Chain c;
    c.read = read;
    c.dir = (uint8_t)((m0 >> 15) & 1);
    c.chain_score = m1 & 0xFFFF;
    c.node = 0;
    c.read_bg = m1 >> 16;
    c.chr_id = cid;
    c.ref_bg = ref_begin0 - chr_starts[cid];
    c.path_off = (int32_t)off;
    c.plen = plen;
    if (read != cur_read) {
      if (!ro.chain_ids.empty()) ctx->reads.push_back(std::move(ro));
      ro = ReadOut();
      ro.read = read;
      ro.max_chain_score = 0;  // filter already applied on device
      cur_read = read;
    }
    ctx->chains.push_back(std::move(c));
    int32_t cid2 = (int32_t)ctx->chains.size() - 1;
    ro.chain_ids.push_back(cid2);
    score_chain(ctx, &ctx->chains[cid2], /*collect=*/true);
  }
  if (!ro.chain_ids.empty()) ctx->reads.push_back(std::move(ro));
  *n_req_out = (int32_t)ctx->reqs.size();
  return ctx;
}

void glue_req_sizes(void* vctx, int32_t* qlen_out, int32_t* tlen_out) {
  Ctx* ctx = (Ctx*)vctx;
  for (size_t k = 0; k < ctx->reqs.size(); k++) {
    qlen_out[k] = ctx->reqs[k].qlen_act;
    tlen_out[k] = ctx->reqs[k].tlen;
  }
}

// Per-request metadata so the DEVICE can build the DP code matrices from
// its resident read words + reference (glue_fill_dp semantics, minus the
// host->device matrix transfer). Layout: 5 x n_req int32 rows —
// [flat query base = (read + dir*n_pad)*L + read_st, qlen_act,
//  ref_st clamped at 0, tlen, reversed (TYPE_LEFT)].
void glue_req_meta(void* vctx, int32_t* out) {
  Ctx* ctx = (Ctx*)vctx;
  int64_t n = (int64_t)ctx->reqs.size();
  for (int64_t k = 0; k < n; k++) {
    const DpReq& r = ctx->reqs[k];
    out[k] = (r.read + (r.dir ? ctx->n_pad : 0)) * ctx->L + r.read_st;
    out[n + k] = r.qlen_act;
    out[2 * n + k] = (int32_t)(r.ref_st < 0 ? 0 : r.ref_st);
    out[3 * n + k] = r.tlen;
    out[4 * n + k] = (r.type == TYPE_LEFT) ? 1 : 0;
  }
}

void glue_fill_dp(void* vctx, const int32_t* members, int32_t n_members,
                  int32_t* qc, int32_t* tc, int32_t* ql, int32_t* tl,
                  int32_t cq, int32_t ct) {
  Ctx* ctx = (Ctx*)vctx;
  for (int32_t m = 0; m < n_members; m++) {
    const DpReq& r = ctx->reqs[members[m]];
    const uint8_t* read =
        (r.dir == 0 ? ctx->codes_f : ctx->codes_r) +
        (int64_t)r.read * ctx->L;
    int32_t* qrow = qc + (int64_t)m * cq;
    int32_t* trow = tc + (int64_t)m * ct;
    int32_t qa = r.qlen_act;
    if (r.type == TYPE_LEFT) {
      for (int32_t j = 0; j < qa; j++)
        qrow[j] = read[r.read_st + qa - 1 - j];
      for (int32_t j = 0; j < r.tlen; j++) {
        int64_t pos = (r.ref_st < 0 ? 0 : r.ref_st) + (r.tlen - 1 - j);
        trow[j] = pos < ctx->ref_len ? ctx->packed_ref[pos] : 0;
      }
    } else {
      for (int32_t j = 0; j < qa; j++) qrow[j] = read[r.read_st + j];
      for (int32_t j = 0; j < r.tlen; j++) {
        int64_t pos = (r.ref_st < 0 ? 0 : r.ref_st) + j;
        trow[j] = pos < ctx->ref_len ? ctx->packed_ref[pos] : 0;
      }
    }
    ql[m] = qa;
    tl[m] = r.tlen;
  }
}

// device results for one chunk. packed rows: score, mqe, max, max_q,
// max_t, zdropped, i_f, j_f (engine._dp_scan_body). ops rows are
// BACKWARD op codes; 3 terminates a row.
void glue_set_dp_chunk(void* vctx, const int32_t* members,
                       int32_t n_members, const int8_t* ops,
                       int32_t ops_len, const int32_t* packed,
                       int32_t chunk_B) {
  Ctx* ctx = (Ctx*)vctx;
  const int32_t* score = packed;
  const int32_t* mqe = packed + chunk_B;
  const int32_t* zdr = packed + 5 * (int64_t)chunk_B;
  const int32_t* i_f = packed + 6 * (int64_t)chunk_B;
  const int32_t* j_f = packed + 7 * (int64_t)chunk_B;
  for (int32_t m = 0; m < n_members; m++) {
    DpReq& r = ctx->reqs[members[m]];
    r.score = score[m];
    r.mqe = mqe[m];
    r.zdropped = (uint8_t)zdr[m];
    r.cigar.clear();
    const int8_t* row = ops + (int64_t)m * ops_len;
    // backward ops -> forward runs (ops_to_cigar)
    std::vector<Run> back;
    for (int32_t k = 0; k < ops_len; k++) {
      int8_t c = row[k];
      if (c == 3) break;
      if (!back.empty() && back.back().op == (uint8_t)c)
        back.back().n++;
      else
        back.push_back({(uint8_t)c, 1});
    }
    if (i_f[m] >= 0) {
      if (!back.empty() && back.back().op == 2)
        back.back().n += i_f[m] + 1;
      else
        back.push_back({2, i_f[m] + 1});
    }
    if (j_f[m] >= 0) {
      if (!back.empty() && back.back().op == 1)
        back.back().n += j_f[m] + 1;
      else
        back.push_back({1, j_f[m] + 1});
    }
    r.cigar.assign(back.rbegin(), back.rend());
  }
}

void glue_set_dp_scalar(void* vctx, int32_t req, int32_t score, int32_t mqe,
                        int32_t zdropped, const uint8_t* run_op,
                        const int32_t* run_len, int32_t n_runs) {
  Ctx* ctx = (Ctx*)vctx;
  DpReq& r = ctx->reqs[req];
  r.score = score;
  r.mqe = mqe;
  r.zdropped = (uint8_t)zdropped;
  r.cigar.clear();
  for (int32_t k = 0; k < n_runs; k++) r.cigar.push_back({run_op[k], run_len[k]});
}

// second pass: rebuild cigars + scores, rank, emit result arrays
void glue_replay(void* vctx) {
  Ctx* ctx = (Ctx*)vctx;
  std::vector<Run> merged;
  for (ReadOut& ro : ctx->reads) {
    // replay walks in collect order
    std::vector<int32_t> kept;
    for (int32_t cid : ro.chain_ids) {
      Chain& ch = ctx->chains[cid];
      score_chain(ctx, &ch, /*collect=*/false);
      ch.ref_bg -= ch.rba;
      if (ch.align_score < 0) ch.align_score = 0;
      ch.cigar_ok = reverse_merge(ch.cigar, ctx->lens[ch.read], &merged);
      if (ch.cigar_ok)
        ch.cigar = merged;
      else
        ch.cigar.clear();
      kept.push_back(cid);
    }
    std::stable_sort(kept.begin(), kept.end(), [&](int32_t a, int32_t b) {
      return ctx->chains[a].align_score > ctx->chains[b].align_score;
    });
    if (kept.empty() ||
        ctx->chains[kept[0]].align_score < MIN_ALN_SCORE)
      continue;
    int32_t second =
        kept.size() > 1 ? ctx->chains[kept[1]].align_score : 0;
    for (size_t j = 0; j < kept.size(); j++) {
      Chain& ch = ctx->chains[kept[j]];
      int32_t sv_id = ch.chr_id;
      int64_t ref_bg = ch.ref_bg + ctx->sv_st_pos[sv_id] - 1;
      int32_t mapq = 0;
      if (j == 0) {
        mapq = ch.align_score - second;
        if (mapq > 40) mapq = 40;
      }
      ctx->res_read.push_back(ch.read);
      ctx->res_fields.push_back(ch.dir);
      ctx->res_fields.push_back(ch.chain_score);
      ctx->res_fields.push_back(ch.align_score);
      ctx->res_fields.push_back(ch.read_bg);
      ctx->res_fields.push_back((int32_t)ref_bg);
      ctx->res_fields.push_back(sv_id);
      ctx->res_fields.push_back(mapq);
      ctx->res_fields.push_back((int32_t)j);
      ctx->res_cig_off.push_back((int32_t)ctx->out_cig_op.size());
      ctx->res_cig_n.push_back((int32_t)ch.cigar.size());
      for (const Run& r : ch.cigar) {
        ctx->out_cig_op.push_back(r.op);
        ctx->out_cig_len.push_back(r.n);
      }
    }
  }
}

void glue_out_sizes(void* vctx, int64_t* n_results, int64_t* n_cig) {
  Ctx* ctx = (Ctx*)vctx;
  *n_results = (int64_t)ctx->res_read.size();
  *n_cig = (int64_t)ctx->out_cig_op.size();
}

void glue_copy_out(void* vctx, int32_t* res_read, int32_t* res_fields,
                   uint8_t* cig_op, int32_t* cig_len, int32_t* res_cig_off,
                   int32_t* res_cig_n) {
  Ctx* ctx = (Ctx*)vctx;
  std::memcpy(res_read, ctx->res_read.data(),
              ctx->res_read.size() * sizeof(int32_t));
  std::memcpy(res_fields, ctx->res_fields.data(),
              ctx->res_fields.size() * sizeof(int32_t));
  std::memcpy(cig_op, ctx->out_cig_op.data(), ctx->out_cig_op.size());
  std::memcpy(cig_len, ctx->out_cig_len.data(),
              ctx->out_cig_len.size() * sizeof(int32_t));
  std::memcpy(res_cig_off, ctx->res_cig_off.data(),
              ctx->res_cig_off.size() * sizeof(int32_t));
  std::memcpy(res_cig_n, ctx->res_cig_n.data(),
              ctx->res_cig_n.size() * sizeof(int32_t));
}

void glue_free(void* vctx) { delete (Ctx*)vctx; }

// ---------------------------------------------------------------------
// Banded dual-affine-gap DP with CIGAR ("extd2" semantics) — a scalar
// C++ port of pansvr_tpu/ops/ksw2_ref.py (the repo's fuzz-verified
// behavioral oracle for src/kswlib/ksw2_extd2_sse.c). Bit-identical to
// the oracle (tests/test_native_glue.py fuzz); used for the CPU
// deployments and oversize-segment fallbacks where the Python oracle's
// ~0.1 s/problem is three orders of magnitude too slow.
// ---------------------------------------------------------------------

static const int32_t KNEG_INF = -0x40000000;

int32_t glue_extd2(const uint8_t* query, int32_t qlen, const uint8_t* target,
                   int32_t tlen, int32_t match, int32_t mismatch, int32_t q,
                   int32_t e, int32_t q2, int32_t e2, int32_t w,
                   int32_t zdrop, int32_t with_cigar,
                   int32_t* out_scores,  // [score,mqe,mqe_t,mte,mte_q,max,max_q,max_t,zdropped]
                   uint8_t* cig_op, int32_t* cig_len) {
  for (int k = 0; k < 9; k++) out_scores[k] = 0;
  out_scores[0] = out_scores[1] = out_scores[3] = out_scores[5] = KNEG_INF;
  out_scores[2] = out_scores[4] = out_scores[6] = out_scores[7] = -1;
  out_scores[5] = 0;  // ez.max starts at 0
  if (qlen <= 0 || tlen <= 0) return 0;
  if (q2 + e2 < q + e) {
    std::swap(q, q2);
    std::swap(e, e2);
  }
  if (w < 0) w = std::max(tlen, qlen);
  const int32_t wl = w, wr = w;
  const int32_t tlen_pad = ((tlen + 15) / 16) * 16;
  int32_t n_col = std::min(qlen, tlen);
  n_col = ((std::min(n_col, w + 1) + 15) / 16 + 1) * 16;
  if (-mismatch > 2 * (q + e)) return 0;

  int32_t long_thres = (e != e2) ? (q2 - q) / (e - e2) - 1 : 0;
  if (q2 + e2 + long_thres * e2 > q + e + long_thres * e) long_thres++;
  const int32_t long_diff = long_thres * (e - e2) - (q2 - q) - e2;

  std::vector<int32_t> u(tlen_pad, -q - e), v(tlen_pad, -q - e);
  std::vector<int32_t> x(tlen_pad, -q - e), y(tlen_pad, -q - e);
  std::vector<int32_t> x2(tlen_pad, -q2 - e2), y2(tlen_pad, -q2 - e2);
  std::vector<int32_t> s(tlen_pad, 0);
  std::vector<int64_t> H(tlen_pad, (int64_t)KNEG_INF);
  const int32_t n_diag = qlen + tlen - 1;
  std::vector<int32_t> off(n_diag, 0), off_end(n_diag, 0);
  std::vector<uint8_t> p;
  // row stride: one extra 16-lane vector of slack, mirroring the
  // reference allocation (ksw2_extd2_sse.c:115) — the padded [st,en]
  // span can exceed n_col by up to one vector
  const int32_t p_stride = n_col + 16;
  if (with_cigar) p.assign((size_t)n_diag * p_stride, 0);

  int32_t mqe = KNEG_INF, mqe_t = -1, mte = KNEG_INF, mte_q = -1;
  int32_t ezmax = 0, max_q = -1, max_t_g = -1, score = KNEG_INF;
  bool zdropped = false;
  int32_t last_st = -1, last_en = -1;
  int32_t r;
  for (r = 0; r < n_diag; r++) {
    int32_t st0 = std::max(0, std::max(r - qlen + 1, (r - wr + 1) >> 1));
    int32_t en0 = std::min(tlen - 1, std::min(r, (r + wl) >> 1));
    if (st0 > en0) {
      zdropped = true;
      break;
    }
    const int32_t st = st0 / 16 * 16;
    int32_t en = (en0 + 16) / 16 * 16 - 1;
    if (en > tlen_pad - 1) en = tlen_pad - 1;
    off[r] = st;
    off_end[r] = en;

    int32_t x1, x21, v1;
    if (st > 0) {
      if (last_st <= st - 1 && st - 1 <= last_en) {
        x1 = x[st - 1];
        x21 = x2[st - 1];
        v1 = v[st - 1];
      } else {
        x1 = -q - e;
        x21 = -q2 - e2;
        v1 = -q - e;
      }
    } else {
      x1 = -q - e;
      x21 = -q2 - e2;
      v1 = (r == 0) ? -q - e
                    : (r < long_thres ? -e
                                      : (r == long_thres ? long_diff : -e2));
    }
    if (en >= r) {
      y[r] = -q - e;
      y2[r] = -q2 - e2;
      u[r] = (r == 0) ? -q - e
                      : (r < long_thres ? -e
                                        : (r == long_thres ? long_diff : -e2));
    }
    for (int32_t t = st0; t <= en0; t++)
      s[t] = (query[r - t] == target[t]) ? match : mismatch;

    uint8_t* prow = with_cigar ? &p[(size_t)r * p_stride] : nullptr;
    int32_t xp = x1, vp = v1, x2p = x21;
    for (int32_t t = st; t <= en; t++) {
      int32_t a = xp + vp;
      int32_t b = y[t] + u[t];
      int32_t a2 = x2p + vp;
      int32_t b2 = y2[t] + u[t];
      int32_t z = s[t];
      uint8_t dc = 0;
      if (a > z) { z = a; dc = 1; }
      if (b > z) { z = b; dc = 2; }
      if (a2 > z) { z = a2; dc = 3; }
      if (b2 > z) { z = b2; dc = 4; }
      if (z > match) z = match;
      const int32_t u_new = z - vp;
      const int32_t v_new = z - u[t];
      a -= (z - q);
      b -= (z - q);
      a2 -= (z - q2);
      b2 -= (z - q2);
      xp = x[t];
      vp = v[t];
      x2p = x2[t];
      x[t] = std::max(a, 0) - q - e;
      if (a > 0) dc |= 0x08;
      y[t] = std::max(b, 0) - q - e;
      if (b > 0) dc |= 0x10;
      x2[t] = std::max(a2, 0) - q2 - e2;
      if (a2 > 0) dc |= 0x20;
      y2[t] = std::max(b2, 0) - q2 - e2;
      if (b2 > 0) dc |= 0x40;
      u[t] = u_new;
      v[t] = v_new;
      if (prow) prow[t - st] = dc;
    }

    int32_t max_t;
    int64_t max_H;
    if (r > 0) {
      const int64_t H_en0 =
          (en0 > 0) ? H[en0 - 1] + u[en0] : H[en0] + v[en0];
      for (int32_t t = st0; t < en0; t++) H[t] += v[t];
      H[en0] = H_en0;
      max_t = en0;
      max_H = H[en0];
      for (int32_t t = st0; t < en0; t++)
        if (H[t] > max_H) {
          max_H = H[t];
          max_t = t;
        }
    } else {
      H[0] = (int64_t)v[0] - (q + e);
      max_H = H[0];
      max_t = 0;
    }

    if (en0 == tlen - 1 && H[en0] > mte) {
      mte = (int32_t)H[en0];
      mte_q = r - en;
    }
    if (r - st0 == qlen - 1 && H[st0] > mqe) {
      mqe = (int32_t)H[st0];
      mqe_t = st0;
    }
    // ksw_apply_zdrop (is_rot=1)
    if (max_H > ezmax) {
      ezmax = (int32_t)max_H;
      max_t_g = max_t;
      max_q = r - max_t;
    } else if (max_t >= max_t_g && r - max_t >= max_q) {
      const int32_t tl = max_t - max_t_g;
      const int32_t ql = (r - max_t) - max_q;
      const int32_t l = tl > ql ? tl - ql : ql - tl;
      if (zdrop >= 0 && ezmax - max_H > zdrop + (int64_t)l * e2) {
        zdropped = true;
        break;
      }
    }
    if (r == qlen + tlen - 2 && en0 == tlen - 1) score = (int32_t)H[tlen - 1];
    last_st = st;
    last_en = en;
  }

  out_scores[0] = score;
  out_scores[1] = mqe;
  out_scores[2] = mqe_t;
  out_scores[3] = mte;
  out_scores[4] = mte_q;
  out_scores[5] = ezmax;
  out_scores[6] = max_q;
  out_scores[7] = max_t_g;
  out_scores[8] = zdropped ? 1 : 0;

  int32_t n_cig = 0;
  if (with_cigar) {
    int32_t i0 = -1, j0 = -1;
    if (!zdropped) {
      i0 = tlen - 1;
      j0 = qlen - 1;
    } else if (max_t_g >= 0 && max_q >= 0) {
      i0 = max_t_g;
      j0 = max_q;
    }
    if (i0 >= 0 && j0 >= 0) {
      // ksw_backtrack_D, is_rot=1 (ops emitted backward, reversed below)
      std::vector<std::pair<uint8_t, int32_t>> ops;
      auto push = [&](uint8_t op, int32_t n) {
        if (!ops.empty() && ops.back().first == op)
          ops.back().second += n;
        else
          ops.push_back({op, n});
      };
      int32_t i = i0, j = j0, state = 0;
      while (i >= 0 && j >= 0) {
        const int32_t rr = i + j;
        int32_t force_state = -1;
        if (i < off[rr]) force_state = 2;
        if (i > off_end[rr]) force_state = 1;
        const int32_t tmp =
            (force_state < 0) ? p[(size_t)rr * p_stride + (i - off[rr])] : 0;
        if (state == 0)
          state = tmp & 7;
        else if (!((tmp >> (state + 2)) & 1))
          state = 0;
        if (state == 0) state = tmp & 7;
        if (force_state >= 0) state = force_state;
        if (state == 0) {
          push(0, 1);  // M
          i--;
          j--;
        } else if (state == 1 || state == 3) {
          push(2, 1);  // D consumes target
          i--;
        } else {
          push(1, 1);  // I consumes query
          j--;
        }
      }
      if (i >= 0) push(2, i + 1);
      if (j >= 0) push(1, j + 1);
      n_cig = (int32_t)ops.size();
      for (int32_t k = 0; k < n_cig; k++) {
        cig_op[k] = ops[n_cig - 1 - k].first;
        cig_len[k] = ops[n_cig - 1 - k].second;
      }
    }
  }
  return n_cig;
}

// STR pre-screen: per row, the number of duplicate k-mers (n_kmer minus
// distinct count) — the same quantity the engine's NumPy screen derives
// from a row sort (engine._submit_batch_inner), computed here for every
// row in one pass. The screen is a strict superset of the reference's
// STR rule distinct < n_kmer - 15 (read_realignment.cpp:552-597); rows
// passing it get the exact per-read _detect_str.
void glue_str_dup(const uint8_t* codes, const int32_t* lens,
                  int32_t n_rows, int32_t L, int32_t kmer_len,
                  int32_t* n_dup_out) {
  // rows are independent: split across a small thread pool (this is
  // ~50 ms/batch single-threaded and sits on the host-prep critical
  // path of align_stream)
  const uint64_t mask =
      (2 * kmer_len >= 64) ? ~0ull : ((1ull << (2 * kmer_len)) - 1);
  auto worker = [&](int32_t lo, int32_t hi) {
    std::vector<uint64_t> buf;
    for (int32_t i = lo; i < hi; i++) {
      int32_t rl = lens[i];
      int32_t nk = rl - kmer_len + 1;
      if (nk <= 0) {
        n_dup_out[i] = 0;
        continue;
      }
      buf.clear();
      buf.reserve(nk);
      const uint8_t* c = codes + (int64_t)i * L;
      uint64_t v = 0;
      for (int32_t j = 0; j < rl; j++) {
        v = ((v << 2) | (uint64_t)(c[j] & 3)) & mask;
        if (j >= kmer_len - 1) buf.push_back(v);
      }
      std::sort(buf.begin(), buf.end());
      int32_t d = 0;
      for (size_t j = 1; j < buf.size(); j++) d += (buf[j] == buf[j - 1]);
      n_dup_out[i] = d;
    }
  };
  int nt = (int)std::thread::hardware_concurrency();
  if (nt > 4) nt = 4;
  if (nt < 1 || n_rows < 1024) nt = 1;
  if (nt == 1) {
    worker(0, n_rows);
    return;
  }
  std::vector<std::thread> ts;
  int32_t step = (n_rows + nt - 1) / nt;
  for (int t = 0; t < nt; t++) {
    int32_t lo = t * step, hi = std::min(n_rows, lo + step);
    if (lo < hi) ts.emplace_back(worker, lo, hi);
  }
  for (auto& th : ts) th.join();
}

// ---------------------------------------------------------------------
// fc_signal block scan: parse raw BAM record bodies, greedily pair
// mates inside the block and run the 7-rule signal filter — the native
// form of signal/extract.py's _pair_block + classify_pair (behavioral
// spec: getSignalRead.cpp:100-256,305-420). Python keeps only the
// FASTQ emission for pairs this pass marks as signal.
//
// Inputs: blob = concatenated record bodies, offs = (n+1) offsets.
// Outputs per record i:
//   cols[i*8+0] score_by_cigar   (getSignalRead.cpp:36-77)
//   cols[i*8+1] soft_left        (clip at cigar head, S/H)
//   cols[i*8+2] clip_sum         (head + tail S/H)
//   cols[i*8+3] low_quality_len  (qual bases below '/')
//   cols[i*8+4] NM tag (0 if absent)
//   cols[i*8+5] xa_number        (get_XA_number, cpp:81-93)
//   cols[i*8+6] l_seq
//   cols[i*8+7] 0 (reserved)
//   mate[i]   in-block mate index or -1
//   verdict[i] at the read1 member of each pair: 1 = emit signal,
//              0 = filtered out, -1 = -U full-match discard; else 0
//   reason[i]  reason bitmask of the pair (valid where verdict != -1)

namespace {

struct SigRec {
  int32_t tid, pos, mapq, flag, l_seq, mtid, mpos, isize;
  const uint8_t* name;  // NUL-terminated in blob
  int32_t score, soft_left, clip_sum, lowq, nm, xa;
};

}  // namespace

void glue_signal_scan(const uint8_t* blob, const int64_t* offs, int32_t n,
                      int32_t min_isize, int32_t max_isize,
                      int32_t max_tid, int32_t discard_full,
                      int32_t not_using_filter, int32_t lowq_cutoff,
                      int32_t* cols,
                      int32_t* mate, int32_t* verdict, int32_t* reason) {
  constexpr int32_t MATCH = 2, MISMATCH = 12;
  constexpr int32_t GO = 16, GE = 1, GO2 = 32, GE2 = 0;
  std::vector<SigRec> rec(n);

  for (int32_t i = 0; i < n; i++) {
    const uint8_t* b = blob + offs[i];
    const int64_t blen = offs[i + 1] - offs[i];
    SigRec& r = rec[i];
    std::memcpy(&r.tid, b + 0, 4);
    std::memcpy(&r.pos, b + 4, 4);
    const int32_t l_name = b[8];
    r.mapq = b[9];
    uint16_t n_cigar, flag16;
    std::memcpy(&n_cigar, b + 12, 2);
    std::memcpy(&flag16, b + 14, 2);
    r.flag = flag16;
    std::memcpy(&r.l_seq, b + 16, 4);
    std::memcpy(&r.mtid, b + 20, 4);
    std::memcpy(&r.mpos, b + 24, 4);
    std::memcpy(&r.isize, b + 28, 4);
    r.name = b + 32;

    // cigar walk: score (NM applied below), clips, gap length
    const uint8_t* cg = b + 32 + l_name;
    int32_t score = 0, gap = 0, soft_l = 0, soft_r = 0;
    for (int32_t k = 0; k < n_cigar; k++) {
      uint32_t cv;
      std::memcpy(&cv, cg + 4 * k, 4);
      const int32_t ln = (int32_t)(cv >> 4);
      const int32_t op = (int32_t)(cv & 0xF);  // MIDNSHP=X
      if (op == 0 || op == 7) {  // M, =
        score += ln * MATCH;
      } else if (op == 1 || op == 2 || op == 4 || op == 5) {  // I D S H
        if (op == 1 || op == 2) gap += ln;
        score -= std::min(GO + ln * GE, GO2 + ln * GE2);
      }
      if (op == 4 || op == 5) {
        if (k == 0) soft_l = ln;
        if (k == n_cigar - 1) soft_r = ln;
      }
    }
    r.soft_left = soft_l;
    r.clip_sum = soft_l + soft_r;

    // qual: raw phred below the cutoff; 0xff = missing. The reference
    // compares the '/' char literal (47) against RAW phred
    // (bam_file.c:673-684), so 47 reproduces its behavior
    const uint8_t* q = cg + 4 * n_cigar + (r.l_seq + 1) / 2;
    int32_t lowq = 0;
    if (r.l_seq > 0 && q[0] != 0xFF) {
      for (int32_t k = 0; k < r.l_seq; k++) lowq += (q[k] < lowq_cutoff);
    }
    r.lowq = lowq;

    // aux walk: NM (any int type) + XA semicolon count
    const uint8_t* t = q + r.l_seq;
    const uint8_t* end = blob + offs[i] + blen;
    int32_t nm = 0, xa = -1;
    while (t + 3 <= end) {
      const uint8_t t0 = t[0], t1 = t[1];
      const char ty = (char)t[2];
      t += 3;
      int64_t adv;
      switch (ty) {
        case 'A': adv = 1; break;
        case 'c': case 'C': adv = 1; break;
        case 's': case 'S': adv = 2; break;
        case 'i': case 'I': adv = 4; break;
        case 'f': adv = 4; break;
        case 'Z': case 'H': {
          const uint8_t* z = t;
          while (z < end && *z) z++;
          adv = z - t + 1;
          break;
        }
        case 'B': {
          if (t + 5 > end) { adv = end - t; break; }
          uint32_t cnt;
          std::memcpy(&cnt, t + 1, 4);
          int32_t esz;
          switch ((char)t[0]) {
            case 'c': case 'C': esz = 1; break;
            case 's': case 'S': esz = 2; break;
            default: esz = 4; break;
          }
          adv = 5 + (int64_t)cnt * esz;
          break;
        }
        default: adv = end - t; break;  // unknown: stop (parser parity)
      }
      if (t0 == 'N' && t1 == 'M') {
        switch (ty) {
          case 'c': nm = *(const int8_t*)t; break;
          case 'C': nm = *t; break;
          case 's': { int16_t v; std::memcpy(&v, t, 2); nm = v; break; }
          case 'S': { uint16_t v; std::memcpy(&v, t, 2); nm = v; break; }
          case 'i': case 'I': std::memcpy(&nm, t, 4); break;
          default: break;
        }
      } else if (t0 == 'X' && t1 == 'A' && (ty == 'Z' || ty == 'H')) {
        xa = 0;
        for (const uint8_t* z = t; z < end && *z; z++) xa += (*z == ';');
      }
      t += adv;
    }
    r.nm = nm;
    score -= (MISMATCH + MATCH) * (nm - gap);
    r.score = std::max(0, score);
    r.xa = (r.mapq > 0) ? 0 : (xa < 0 ? 6 : xa);

    int32_t* c8 = cols + (int64_t)i * 8;
    c8[0] = r.score; c8[1] = r.soft_left; c8[2] = r.clip_sum;
    c8[3] = r.lowq; c8[4] = r.nm; c8[5] = r.xa; c8[6] = r.l_seq;
    c8[7] = r.flag;
  }

  // ---- greedy in-block mate pairing (extract._pair_block) ------------
  for (int32_t i = 0; i < n; i++) mate[i] = -1;
  std::unordered_map<int32_t, std::vector<int32_t>> by_pos;
  by_pos.reserve((size_t)n * 2);
  for (int32_t k = 0; k < n; k++) by_pos[rec[k].pos].push_back(k);
  for (int32_t i = 0; i < n; i++) {
    verdict[i] = 0;
    reason[i] = 0;
    if (mate[i] >= 0) continue;
    const SigRec& r = rec[i];
    if (r.tid != r.mtid) continue;
    if (r.tid == -1) {
      for (int32_t d = 0; d < 2; d++) {
        const int32_t k = (d == 0) ? i + 1 : i - 1;
        if (k >= 0 && k < n && mate[k] < 0 &&
            std::strcmp((const char*)rec[k].name, (const char*)r.name) == 0) {
          mate[i] = k;
          mate[k] = i;
          break;
        }
      }
      continue;
    }
    auto it = by_pos.find(r.mpos);
    if (it == by_pos.end()) continue;
    for (const int32_t k : it->second) {
      const SigRec& m = rec[k];
      if (k != i && m.mpos == r.pos && mate[k] < 0 &&
          std::strcmp((const char*)m.name, (const char*)r.name) == 0) {
        mate[i] = k;
        mate[k] = i;
        break;
      }
    }
  }

  // ---- per-pair 7-rule filter (extract.classify_pair) ----------------
  for (int32_t i = 0; i < n; i++) {
    if (mate[i] < 0) continue;
    const SigRec& r1 = rec[i];
    if (!(r1.flag & 0x40)) continue;  // classify at the read1 member
    const SigRec& r2 = rec[mate[i]];
    if (r2.flag & 0x40) continue;     // both-read1: not emitted (parity)
    const int32_t isize = std::abs(r1.isize);
    const bool unm1 = r1.flag & 0x4, unm2 = r2.flag & 0x4;

    if (discard_full) {
      const int32_t min_score =
          (r1.l_seq + r2.l_seq) * MATCH - 4 * (MATCH + MISMATCH);
      const bool near_full = r1.score + r2.score >= min_score;
      const bool isize_ok = isize != 0 && min_isize < isize && isize < max_isize;
      if (near_full && isize_ok && r1.tid == r2.tid && r1.tid <= max_tid &&
          r2.tid <= max_tid) {
        verdict[i] = -1;
        continue;
      }
    }

    bool d0 = !(r1.flag & 0x10), d1 = !(r2.flag & 0x10);
    if (r1.pos > r2.pos) std::swap(d0, d1);
    if (isize == r1.l_seq && isize == r2.l_seq && !d0 && d1) std::swap(d0, d1);

    int32_t clip[2] = {r1.clip_sum, r2.clip_sum};
    int32_t lowq[2] = {r1.lowq, r2.lowq};
    int32_t indel[2] = {r1.nm, r2.nm};
    for (int32_t k = 0; k < 2; k++) {
      clip[k] -= lowq[k];
      if (clip[k] < 0) {
        lowq[k] = -clip[k];
        clip[k] = 0;
      }
      lowq[k] >>= 1;
      indel[k] -= lowq[k];
      if (indel[k] < 0) indel[k] = 0;
    }

    int32_t rs = 0;
    if (r1.mapq < 10 && r2.mapq < 10) rs += 1;
    if (unm1 || unm2) rs += 2;
    if (isize > 1000) rs += 4;
    if (!d0 || d1) rs += 8;
    if (indel[0] + indel[1] > 15) rs += 16;
    if (clip[0] + clip[1] > 10) rs += 32;
    if (r1.tid != r2.tid || r1.tid > max_tid || r2.tid > max_tid) rs += 64;
    reason[i] = rs;
    verdict[i] = (rs != 0 || not_using_filter) ? 1 : 0;
  }
}

}  // extern "C"

// ---------------------------------------------------------------------
// Manta-style word-ladder assembly, one word length: the native form of
// assembly/assembler.py's _build_contigs (_kmer_maps + Tarjan repeat
// search + greedy bidirectional walks). The Python AssemblyManager keeps
// the ladder loop, pseudo-read re-injection and contig selection, and
// falls back to its own loops when this library is absent — outputs are
// bit-identical (tested). Behavioral contract: SURVEY.md §8.1
// (mantaAssembler.cpp:69-677).
//
// Determinism mirrors the Python exactly: word maps are ordered
// (std::map) so "first max in sorted order" seed choice and sorted-root
// Tarjan match; read sets are bitsets, iterated ascending like
// Python's sorted(set).

namespace asmN {

struct Bits {
  std::vector<uint64_t> w;
  explicit Bits(size_t n = 0) : w((n + 63) / 64, 0) {}
  void set(int i) { w[i >> 6] |= 1ull << (i & 63); }
  void reset(int i) { w[i >> 6] &= ~(1ull << (i & 63)); }
  bool test(int i) const { return (w[i >> 6] >> (i & 63)) & 1; }
  int count() const {
    int c = 0;
    for (uint64_t x : w) c += __builtin_popcountll(x);
    return c;
  }
  bool any() const {
    for (uint64_t x : w) if (x) return true;
    return false;
  }
  template <class F>
  void for_each(F f) const {  // ascending
    for (size_t k = 0; k < w.size(); k++) {
      uint64_t x = w[k];
      while (x) {
        f((int)(k * 64 + __builtin_ctzll(x)));
        x &= x - 1;
      }
    }
  }
};

static inline Bits and_(const Bits& a, const Bits& b) {
  Bits r(0);
  r.w.resize(a.w.size());
  for (size_t i = 0; i < a.w.size(); i++) r.w[i] = a.w[i] & b.w[i];
  return r;
}
static inline void bits_or(Bits& a, const Bits& b) {
  for (size_t i = 0; i < a.w.size(); i++) a.w[i] |= b.w[i];
}
// popcount of a &~ b
static inline int diff_count(const Bits& a, const Bits& b) {
  int c = 0;
  for (size_t i = 0; i < a.w.size(); i++)
    c += __builtin_popcountll(a.w[i] & ~b.w[i]);
  return c;
}
static inline void or_diff(Bits& dst, const Bits& a, const Bits& b) {
  for (size_t i = 0; i < a.w.size(); i++) dst.w[i] |= a.w[i] & ~b.w[i];
}

struct Word {
  int32_t count = 0;
  Bits reads;
};

struct Contig {
  std::string seq;
  Bits support, reject;
  int32_t seed_read_count = 0, word_length = 0;
  int32_t ass_begin = 0, cons_bgn = 0, cons_end = 0;
  int32_t ending[2] = {-1, -1};
  std::vector<std::array<int32_t, 3>> actions;  // kmer_index, read, is_add
};

struct AsmCtx {
  std::vector<Contig> contigs;
  int32_t success = 0, global_max_count = 0;
};

constexpr int32_t MAX_ALLELE_AS_SNP = 1;
static const char* ALPHA = "ACGT";

}  // namespace asmN

namespace asmN {

// Key operations: words are 2-bit-packed uint64 when wl <= 31 and the
// input alphabet is {A,C,G,T,N} (packing preserves lexicographic order
// since A<C<G<T matches the code order), else std::string. Both paths
// run the identical algorithm below.
template <bool PACKED>
struct KeyOps;

template <>
struct KeyOps<true> {
  using Key = uint64_t;
  int wl;
  uint64_t sub_mask;
  explicit KeyOps(int wl_)
      : wl(wl_), sub_mask(wl_ > 1 ? ((1ull << (2 * (wl_ - 1))) - 1) : 0) {}
  static int code(char c) {
    switch (c) {
      case 'A': return 0;
      case 'C': return 1;
      case 'G': return 2;
      case 'T': return 3;
    }
    return -1;
  }
  bool enc(const char* s, int n, Key& out) const {
    uint64_t v = 0;
    for (int k = 0; k < n; k++) {
      const int c = code(s[k]);
      if (c < 0) return false;
      v = (v << 2) | (uint64_t)c;
    }
    out = v;
    return true;
  }
  Key append(const Key& trunk, char c) const {  // trunk: wl-1 chars
    return (trunk << 2) | (uint64_t)code(c);
  }
  Key prepend(char c, const Key& trunk) const {
    return ((uint64_t)code(c) << (2 * (wl - 1))) | trunk;
  }
  Key succ(const Key& w, char c) const {  // drop first char, append c
    return ((w & sub_mask) << 2) | (uint64_t)code(c);
  }
  Key front_trunk(const Key& w) const { return w >> 2; }  // first wl-1
  std::string str(const Key& w) const {
    std::string s(wl, 'A');
    for (int i = 0; i < wl; i++) s[i] = ALPHA[(w >> (2 * (wl - 1 - i))) & 3];
    return s;
  }
};

template <>
struct KeyOps<false> {
  using Key = std::string;
  int wl;
  explicit KeyOps(int wl_) : wl(wl_) {}
  bool enc(const char* s, int n, Key& out) const {
    for (int k = 0; k < n; k++)
      if (s[k] == 'N') return false;  // "N" not in w; other chars pass
    out.assign(s, n);
    return true;
  }
  Key append(const Key& trunk, char c) const { return trunk + c; }
  Key prepend(char c, const Key& trunk) const { return c + trunk; }
  Key succ(const Key& w, char c) const { return w.substr(1) + c; }
  Key front_trunk(const Key& w) const { return w.substr(0, wl - 1); }
  std::string str(const Key& w) const { return w; }
};

template <bool PACKED>
static void asm_run_impl(AsmCtx* ctx, const uint8_t* blob,
                         const int64_t* offs, int32_t n_reads,
                         const uint8_t* is_pseudo, int32_t wl,
                         int32_t min_coverage,
                         int32_t min_conservative_coverage,
                         int32_t max_assembly_count,
                         int32_t reject_read_reused) {
  using Ops = KeyOps<PACKED>;
  using Key = typename Ops::Key;
  const Ops ops(wl);

  struct WordT {
    int32_t count = 0;
    Bits reads;
  };

  // ---- _kmer_maps ----------------------------------------------------
  std::map<Key, WordT> words;
  {
    std::vector<Key> per_read;
    for (int32_t r = 0; r < n_reads; r++) {
      const char* s = (const char*)blob + offs[r];
      const int64_t len = offs[r + 1] - offs[r];
      if (len < wl) continue;
      per_read.clear();
      for (int64_t j = 0; j + wl <= len; j++) {
        Key k{};
        if (ops.enc(s + j, wl, k)) per_read.push_back(std::move(k));
      }
      std::sort(per_read.begin(), per_read.end());
      per_read.erase(std::unique(per_read.begin(), per_read.end()),
                     per_read.end());
      const int32_t add = is_pseudo[r] ? min_coverage : 1;
      for (auto& w : per_read) {
        auto& e = words[w];
        if (e.reads.w.empty()) e.reads = Bits(n_reads);
        e.count += add;
        e.reads.set(r);
      }
    }
  }

  // ---- _repeat_words: iterative Tarjan, sorted roots, ACGT succ ------
  std::map<Key, std::array<int32_t, 2>> index_of;
  for (auto& kv : words) index_of[kv.first] = {0, 0};
  std::set<Key> repeats;
  {
    std::vector<Key> stack;
    std::set<Key> on_stack;
    int32_t counter = 1;
    for (auto& root_kv : index_of) {
      const Key& root = root_kv.first;
      if (index_of[root][0] != 0) continue;
      std::vector<std::pair<Key, int32_t>> work;
      work.emplace_back(root, 0);
      index_of[root] = {counter, counter};
      counter++;
      stack.push_back(root);
      on_stack.insert(root);
      while (!work.empty()) {
        auto& top = work.back();
        const Key w = top.first;
        const int32_t si = top.second;
        if (si < 4) {
          top.second = si + 1;
          const Key nxt = ops.succ(w, ALPHA[si]);
          if (nxt == w) {
            repeats.insert(w);
            continue;
          }
          auto it = index_of.find(nxt);
          if (it == index_of.end()) continue;
          if (it->second[0] == 0) {
            it->second = {counter, counter};
            counter++;
            stack.push_back(nxt);
            on_stack.insert(nxt);
            work.emplace_back(nxt, 0);
          } else if (on_stack.count(nxt)) {
            auto& iw = index_of[w];
            iw[1] = std::min(iw[1], it->second[0]);
          }
          continue;
        }
        work.pop_back();
        if (!work.empty()) {
          auto& ip = index_of[work.back().first];
          ip[1] = std::min(ip[1], index_of[w][1]);
        }
        auto& iw = index_of[w];
        if (iw[1] == iw[0]) {
          if (stack.back() == w) {
            stack.pop_back();
            on_stack.erase(w);
          } else {
            const bool small = (index_of[stack.back()][0] - iw[0]) <= 50;
            while (true) {
              Key rw = stack.back();
              stack.pop_back();
              on_stack.erase(rw);
              if (small) repeats.insert(rw);
              if (rw == w) break;
            }
          }
        }
      }
    }
  }

  std::set<Key> unused;
  for (auto& kv : words)
    if (kv.second.count >= min_coverage) unused.insert(kv.first);

  // ---- _build_contigs loop -------------------------------------------
  ctx->success = 1;
  int32_t normal_contig = 0;
  while (!unused.empty() && normal_contig < 2 * max_assembly_count) {
    // first max in sorted order
    Key max_word{};
    bool have_seed = false;
    int32_t max_count = 0;
    for (auto& w : unused) {
      const int32_t c = words[w].count;
      if (c > max_count) {
        max_word = w;
        max_count = c;
        have_seed = true;
      }
    }
    if (!have_seed) break;  // unreachable (unused only holds count>=min)
    ctx->global_max_count = std::max(ctx->global_max_count, max_count);

    // ---- _walk -------------------------------------------------------
    Contig contig;
    contig.seq = ops.str(max_word);
    contig.word_length = wl;
    contig.support = words[max_word].reads;
    contig.reject = Bits(n_reads);
    contig.seed_read_count = contig.support.count();
    contig.support.for_each(
        [&](int rd) { contig.actions.push_back({0, rd, 1}); });
    unused.erase(max_word);
    bool is_repeat_found = false;

    if (repeats.count(max_word)) {
      contig.cons_bgn = 0;
      contig.cons_end = wl;
      contig.ending[0] = 1;
      contig.ending[1] = 1;
      // the Python path returns before the final cons_end adjustment
      ctx->contigs.push_back(std::move(contig));
      if ((int32_t)ctx->contigs.back().seq.size() > wl) normal_contig++;
      ctx->success = 0;
      continue;
    }

    std::set<Key> words_in_contig{max_word};
    {
      const Key trunk0 = ops.front_trunk(max_word);
      const char last_c = contig.seq[wl - 1];
      for (int a = 0; a < 4; a++) {
        if (ALPHA[a] == last_c) continue;
        auto it = words.find(ops.append(trunk0, ALPHA[a]));
        if (it != words.end()) bits_or(contig.reject, it->second.reads);
      }
    }

    int32_t kmer_index = 0;
    for (int mode = 0; mode < 2; mode++) {
      const bool at_end = mode == 0;
      const int32_t step = at_end ? 1 : -1;
      kmer_index = 0;
      int32_t conservative_off = 0;
      while (true) {
        const size_t cl = contig.seq.size();
        // tmp_sym = first char of the trailing wl-window (at_end) or
        // last char of the leading wl-window
        const char tmp_sym =
            at_end ? contig.seq[cl - wl] : contig.seq[wl - 1];
        Key trunk{};
        ops.enc(at_end ? contig.seq.data() + (cl - (wl - 1))
                       : contig.seq.data(),
                wl - 1, trunk);
        int32_t max_base_count = 0;
        Bits max_contig_word_reads(n_reads), max_word_reads(n_reads);
        bool have_max = false, have_max_wr = false;
        Key cur_max_word{};
        char max_base = 'A';
        Bits support_to_remove(n_reads), reject_to_add(n_reads);

        for (int a = 0; a < 4; a++) {
          const Key new_key = at_end ? ops.append(trunk, ALPHA[a])
                                     : ops.prepend(ALPHA[a], trunk);
          auto it = words.find(new_key);
          if (it == words.end()) continue;
          const Bits& curr_reads = it->second.reads;
          Bits contig_word_reads = and_(contig.support, curr_reads);
          Bits shared = and_(max_contig_word_reads, curr_reads);
          if (!contig_word_reads.any()) continue;
          if (contig_word_reads.count() > max_contig_word_reads.count()) {
            if (have_max && max_contig_word_reads.any()) {
              if (diff_count(max_contig_word_reads, shared) >
                  MAX_ALLELE_AS_SNP)
                or_diff(support_to_remove, max_contig_word_reads, shared);
            }
            if (have_max_wr && max_word_reads.any()) {
              if (diff_count(max_word_reads, shared) > MAX_ALLELE_AS_SNP)
                or_diff(reject_to_add, max_word_reads, shared);
            }
            max_word_reads = curr_reads;
            have_max_wr = true;
            max_contig_word_reads = std::move(contig_word_reads);
            have_max = true;
            max_base_count = it->second.count;
            max_base = ALPHA[a];
            cur_max_word = new_key;
          } else {
            if (diff_count(contig_word_reads, shared) > MAX_ALLELE_AS_SNP)
              or_diff(support_to_remove, contig_word_reads, shared);
            if (diff_count(curr_reads, shared) > MAX_ALLELE_AS_SNP)
              or_diff(reject_to_add, curr_reads, shared);
          }
        }

        if (max_base_count < min_coverage) {
          contig.ending[1 - mode] = 0;
          break;
        }
        if (words_in_contig.count(cur_max_word)) {
          is_repeat_found = true;
          contig.ending[1 - mode] = 1;
          break;
        }

        if (at_end)
          contig.seq.push_back(max_base);
        else
          contig.seq.insert(contig.seq.begin(), max_base);
        kmer_index += step;
        if (conservative_off != 0 ||
            max_base_count < min_conservative_coverage)
          conservative_off++;

        for (int a = 0; a < 4; a++) {
          if (ALPHA[a] == tmp_sym) continue;
          const Key back_key = at_end ? ops.prepend(ALPHA[a], trunk)
                                      : ops.append(trunk, ALPHA[a]);
          if (back_key == cur_max_word) continue;
          auto it = words.find(back_key);
          if (it == words.end()) continue;
          const Bits& back_reads = it->second.reads;
          Bits shared_al = and_(max_contig_word_reads, back_reads);
          if (diff_count(back_reads, shared_al) > MAX_ALLELE_AS_SNP) {
            or_diff(reject_to_add, back_reads, shared_al);
            or_diff(support_to_remove, back_reads, shared_al);
          }
        }

        bits_or(contig.reject, reject_to_add);
        max_word_reads.for_each([&](int rd) {
          if (reject_read_reused) {
            if (!contig.support.test(rd)) {
              contig.support.set(rd);
              contig.actions.push_back({kmer_index, rd, 1});
            }
          } else {
            if (!contig.reject.test(rd) && !contig.support.test(rd)) {
              contig.support.set(rd);
              contig.actions.push_back({kmer_index, rd, 1});
            }
          }
        });
        support_to_remove.for_each([&](int rd) {
          if (contig.support.test(rd)) {
            contig.support.reset(rd);
            contig.actions.push_back({kmer_index, rd, 0});
          }
        });

        unused.erase(cur_max_word);
        words_in_contig.insert(cur_max_word);
      }

      if (mode == 0)
        contig.cons_end = conservative_off;
      else
        contig.cons_bgn = conservative_off;
    }

    contig.ass_begin = std::min(kmer_index, 0);
    contig.cons_end = (int32_t)contig.seq.size() - contig.cons_end;
    if (is_repeat_found) ctx->success = 0;
    if ((int32_t)contig.seq.size() > wl) normal_contig++;
    ctx->contigs.push_back(std::move(contig));
  }
}

}  // namespace asmN

extern "C" void* glue_asm_run(
    const uint8_t* blob, const int64_t* offs, int32_t n_reads,
    const uint8_t* is_pseudo, int32_t wl, int32_t min_coverage,
    int32_t min_conservative_coverage, int32_t max_assembly_count,
    int32_t reject_read_reused) {
  using namespace asmN;
  auto* ctx = new AsmCtx();
  bool packable = wl <= 31;
  if (packable) {
    const int64_t total = offs[n_reads];
    for (int64_t i = 0; i < total && packable; i++) {
      switch ((char)blob[i]) {
        case 'A': case 'C': case 'G': case 'T': case 'N': break;
        default: packable = false;
      }
    }
  }
  if (packable)
    asm_run_impl<true>(ctx, blob, offs, n_reads, is_pseudo, wl,
                       min_coverage, min_conservative_coverage,
                       max_assembly_count, reject_read_reused);
  else
    asm_run_impl<false>(ctx, blob, offs, n_reads, is_pseudo, wl,
                        min_coverage, min_conservative_coverage,
                        max_assembly_count, reject_read_reused);
  return ctx;
}

extern "C" void glue_asm_sizes(void* vctx, int64_t* out) {
  using namespace asmN;
  auto* ctx = (AsmCtx*)vctx;
  int64_t seq = 0, sup = 0, rej = 0, act = 0;
  for (auto& c : ctx->contigs) {
    seq += c.seq.size();
    sup += c.support.count();
    rej += c.reject.count();
    act += c.actions.size();
  }
  out[0] = (int64_t)ctx->contigs.size();
  out[1] = seq;
  out[2] = sup;
  out[3] = rej;
  out[4] = act;
  out[5] = ctx->success;
  out[6] = ctx->global_max_count;
}

extern "C" void glue_asm_copy(void* vctx, uint8_t* seq_blob,
                              int64_t* seq_offs, int32_t* sup_ids,
                              int64_t* sup_offs, int32_t* rej_ids,
                              int64_t* rej_offs, int32_t* act_vals,
                              int64_t* act_offs, int32_t* meta) {
  using namespace asmN;
  auto* ctx = (AsmCtx*)vctx;
  int64_t so = 0, uo = 0, ro = 0, ao = 0;
  for (size_t i = 0; i < ctx->contigs.size(); i++) {
    Contig& c = ctx->contigs[i];
    seq_offs[i] = so;
    std::memcpy(seq_blob + so, c.seq.data(), c.seq.size());
    so += c.seq.size();
    sup_offs[i] = uo;
    c.support.for_each([&](int rd) { sup_ids[uo++] = rd; });
    rej_offs[i] = ro;
    c.reject.for_each([&](int rd) { rej_ids[ro++] = rd; });
    act_offs[i] = ao;
    for (auto& a : c.actions) {
      act_vals[3 * ao] = a[0];
      act_vals[3 * ao + 1] = a[1];
      act_vals[3 * ao + 2] = a[2];
      ao++;
    }
    int32_t* m = meta + i * 8;
    m[0] = c.seed_read_count;
    m[1] = c.word_length;
    m[2] = c.ass_begin;
    m[3] = c.cons_bgn;
    m[4] = c.cons_end;
    m[5] = c.ending[0];
    m[6] = c.ending[1];
    m[7] = 0;
  }
  seq_offs[ctx->contigs.size()] = so;
  sup_offs[ctx->contigs.size()] = uo;
  rej_offs[ctx->contigs.size()] = ro;
  act_offs[ctx->contigs.size()] = ao;
}

extern "C" void glue_asm_free(void* vctx) { delete (asmN::AsmCtx*)vctx; }

// ---------------------------------------------------------------------
// fc_sv record loading: the native form of sv_call._rec_to_loaded
// (signalSAMLoader.hpp:117-157 semantics) over raw BAM record bodies —
// tag extraction (AS/OS/CS/SV/OA/RC), cigar_adjust(4, add_blank), the
// region-2 position shift and the 4-bit seq decode in one pass.
//
// sv_meta: (n_sv, 5) int32 rows [st_pos, ed_pos, bp1, bp2, length];
// sv_types: (n_sv) uint8, 0=INS 1=DEL 2=other.
// nums: (n, 12) int32 [keep, sv_id, contig_pos, mapq, AS, OS, has_cs,
//                      ori_unmapped, xa_num, rc_mapq, rc_chr, n_cigar];
// full=0 fills nums only (the loader's index pass); full=1 also writes
// the adjusted cigar runs (ops 'MIDNSHP=X' codes) and ASCII seq blobs.
extern "C" void glue_sv_load(
    const uint8_t* blob, const int64_t* offs, int32_t n,
    const int32_t* sv_meta, const uint8_t* sv_types, int32_t n_sv,
    int32_t min_score, int32_t full, int32_t* nums, uint8_t* cig_ops,
    int32_t* cig_lens, int64_t* cig_off, uint8_t* seq_blob,
    int64_t* seq_off) {
  static const char SEQ16[] = "=ACMGRSVTWYHKDBN";
  int64_t co = 0, so = 0;
  for (int32_t i = 0; i < n; i++) {
    int32_t* c12 = nums + (int64_t)i * 12;
    std::memset(c12, 0, 12 * sizeof(int32_t));
    if (full) {
      cig_off[i] = co;
      seq_off[i] = so;
    }
    const uint8_t* b = blob + offs[i];
    const uint8_t* end = blob + offs[i + 1];
    int32_t pos, l_seq, isize;
    std::memcpy(&pos, b + 4, 4);
    const int32_t l_name = b[8];
    const int32_t mapq = b[9];
    uint16_t n_cigar;
    std::memcpy(&n_cigar, b + 12, 2);
    std::memcpy(&l_seq, b + 16, 4);
    std::memcpy(&isize, b + 28, 4);
    const uint8_t* cg = b + 32 + l_name;
    const uint8_t* sq = cg + 4 * n_cigar;
    const uint8_t* t = sq + (l_seq + 1) / 2 + l_seq;

    // ---- aux walk --------------------------------------------------
    int32_t as_v = 0, os_v = 0;
    bool has_as = false, has_cs = false, has_sv = false;
    int32_t sv_id = -1;
    bool oa_unmapped = false;
    int32_t xa_num = 0, rc_mapq = 60, rc_chr = 0;
    while (t + 3 <= end) {
      const uint8_t t0 = t[0], t1 = t[1];
      const char ty = (char)t[2];
      t += 3;
      int64_t adv;
      int32_t ival = 0;
      bool is_int = false;
      switch (ty) {
        case 'A': adv = 1; break;
        case 'c': ival = *(const int8_t*)t; is_int = true; adv = 1; break;
        case 'C': ival = *t; is_int = true; adv = 1; break;
        case 's': { int16_t v; std::memcpy(&v, t, 2); ival = v;
                    is_int = true; adv = 2; break; }
        case 'S': { uint16_t v; std::memcpy(&v, t, 2); ival = v;
                    is_int = true; adv = 2; break; }
        case 'i': case 'I': std::memcpy(&ival, t, 4); is_int = true;
                            adv = 4; break;
        case 'f': adv = 4; break;
        case 'Z': case 'H': {
          const uint8_t* z = t;
          while (z < end && *z) z++;
          adv = z - t + 1;
          break;
        }
        case 'B': {
          if (t + 5 > end) { adv = end - t; break; }
          uint32_t cnt;
          std::memcpy(&cnt, t + 1, 4);
          int32_t esz;
          switch ((char)t[0]) {
            case 'c': case 'C': esz = 1; break;
            case 's': case 'S': esz = 2; break;
            default: esz = 4; break;
          }
          adv = 5 + (int64_t)cnt * esz;
          break;
        }
        default: adv = end - t; break;
      }
      if (t0 == 'A' && t1 == 'S' && is_int) { as_v = ival; has_as = true; }
      else if (t0 == 'O' && t1 == 'S' && is_int) os_v = ival;
      else if (t0 == 'C' && t1 == 'S') has_cs = true;
      else if (t0 == 'S' && t1 == 'V' && (ty == 'Z' || ty == 'H')) {
        has_sv = true;
        sv_id = 0;
        for (const uint8_t* z = t; z < end && *z >= '0' && *z <= '9'; z++)
          sv_id = sv_id * 10 + (*z - '0');
      } else if (t0 == 'O' && t1 == 'A' && (ty == 'Z' || ty == 'H')) {
        const uint8_t* z = t;
        while (z < end && *z) z++;
        while (z > t && z[-1] == ';') z--;  // rstrip(';')
        oa_unmapped = (z > t && z[-1] == 'U');
      } else if (t0 == 'R' && t1 == 'C' && (ty == 'Z' || ty == 'H')) {
        // split on ',' and int() fields 0/4/6 like the Python
        // (ValueError on any of the three -> keep all defaults); the
        // other fields' content is irrelevant. Needs >= 7 fields.
        const uint8_t* fst[8];
        const uint8_t* fen[8];
        int fi = 0;
        const uint8_t* z = t;
        fst[0] = z;
        for (; z < end && *z; z++) {
          if (*z == ',') {
            fen[fi++] = z;
            if (fi >= 8) break;
            fst[fi] = z + 1;
          }
        }
        if (fi < 8) fen[fi++] = z;
        if (fi >= 7) {
          auto to_int = [](const uint8_t* s, const uint8_t* e,
                           int32_t* out) -> bool {
            if (s >= e) return false;
            bool neg = false;
            if (*s == '-' || *s == '+') { neg = (*s == '-'); s++; }
            if (s >= e) return false;
            int64_t acc = 0;
            for (; s < e; s++) {
              if (*s < '0' || *s > '9') return false;
              acc = acc * 10 + (*s - '0');
            }
            *out = (int32_t)(neg ? -acc : acc);
            return true;
          };
          int32_t v0, v4, v6;
          if (to_int(fst[0], fen[0], &v0) && to_int(fst[4], fen[4], &v4)
              && to_int(fst[6], fen[6], &v6)) {
            rc_chr = v0;
            rc_mapq = v4;
            xa_num = v6;
          }
        }
      }
      t += adv;
    }
    (void)has_as;

    if (!has_sv || (!has_cs && isize == 0) || sv_id >= n_sv || sv_id < 0
        || as_v < min_score) {
      continue;  // keep stays 0
    }
    if (n_cigar > 512) {  // beyond the fixed scratch: caller redoes in Python
      c12[0] = 2;
      c12[1] = sv_id;
      continue;
    }

    // ---- cigar_adjust(4, add_blank=true) ---------------------------
    // ops layout: code 'MIDNSHP=X' index + length
    constexpr int32_t DST = 4;
    int32_t op_code[512];
    int32_t op_len[512];
    const int32_t nc = n_cigar > 512 ? 512 : n_cigar;
    for (int32_t k = 0; k < nc; k++) {
      uint32_t cv;
      std::memcpy(&cv, cg + 4 * k, 4);
      op_code[k] = (int32_t)(cv & 0xF);
      op_len[k] = (int32_t)(cv >> 4);
    }
    int32_t cur_n = nc;
    int32_t position_adjust = 0;
    {
      int32_t m_len = 0, stable = 0;
      for (int32_t k = 0; k < cur_n; k++) {
        if (op_code[k] == 0) {  // M
          if (op_len[k] > DST) { stable = k; break; }
          m_len += op_len[k];
        }
      }
      if (stable != 0) {
        position_adjust = m_len;
        int32_t ins = m_len;
        for (int32_t k = 0; k < stable; k++) {
          if (op_code[k] == 1) ins += op_len[k];       // I
          else if (op_code[k] == 2) position_adjust += op_len[k];  // D
        }
        int32_t w = 0;
        if (ins != 0) { op_code[w] = 1; op_len[w] = ins; w++; }
        for (int32_t k = stable; k < cur_n; k++, w++) {
          op_code[w] = op_code[k];
          op_len[w] = op_len[k];
        }
        cur_n = w;
      }
    }
    {
      int32_t m_len = 0, stable = 0;
      for (int32_t k = cur_n - 1; k >= 0; k--) {
        if (op_code[k] == 0) {
          if (m_len + op_len[k] > DST) { stable = k; break; }
          m_len += op_len[k];
        }
      }
      if (stable != cur_n - 1) {
        int32_t ins = m_len;
        for (int32_t k = cur_n - 1; k > stable; k--)
          if (op_code[k] == 1) ins += op_len[k];
        cur_n = stable + 1;
        if (ins != 0) { op_code[cur_n] = 1; op_len[cur_n] = ins; cur_n++; }
      }
    }
    // add_blank: pad with zero-length M back to the original count
    for (int32_t k = cur_n; k < nc; k++) { op_code[k] = 0; op_len[k] = 0; }
    cur_n = nc;

    // ---- region-2 shift + contig position --------------------------
    const int32_t* m5 = sv_meta + (int64_t)sv_id * 5;
    const int32_t st_pos = m5[0], ed_pos = m5[1], bp1 = m5[2],
                  bp2 = m5[3], length = m5[4];
    int32_t p = pos + position_adjust;
    if (!has_cs && bp2 < p && p < ed_pos) {
      int32_t adj = 0;
      if (sv_types[sv_id] == 0)
        adj = length - (bp1 - st_pos) - (ed_pos - bp2);
      else if (sv_types[sv_id] == 1)
        adj = bp1 - bp2;
      p += adj;
    }

    c12[0] = 1;
    c12[1] = sv_id;
    c12[2] = p - (st_pos - 1);
    c12[3] = mapq;
    c12[4] = as_v;
    c12[5] = os_v;
    c12[6] = has_cs ? 1 : 0;
    c12[7] = oa_unmapped ? 1 : 0;
    c12[8] = xa_num;
    c12[9] = rc_mapq;
    c12[10] = rc_chr;
    c12[11] = cur_n;

    if (full) {
      for (int32_t k = 0; k < cur_n; k++) {
        cig_ops[co + k] = (uint8_t)op_code[k];
        cig_lens[co + k] = op_len[k];
      }
      co += cur_n;
      for (int32_t k = 0; k < l_seq; k++) {
        const uint8_t code = (k & 1) ? (sq[k >> 1] & 0xF) : (sq[k >> 1] >> 4);
        seq_blob[so + k] = (uint8_t)SEQ16[code];
      }
      so += l_seq;
    }
  }
  if (full) {
    cig_off[n] = co;
    seq_off[n] = so;
  }
}

// ---------------------------------------------------------------------
// fc_signal native FASTQ renderer: parse raw record bodies, pair mates
// (positional in-block, mode 0, or adjacent-by-name for the phase-2
// leftovers, mode 1), run the 7-rule filter, and render the signal-pair
// FASTQ entries — comment contract of getSignalRead.cpp:158-249 exactly
// as signal/extract.py's _pair_comment/_fastq_entry produce it
// (byte-identical, tested). Record parse and pair render run on
// std::thread workers; pairing and counters stay sequential.

namespace sigr {

struct Rec {
  int32_t tid, pos, mapq, flag, l_seq, mtid, mpos, isize;
  const uint8_t* name;   // NUL-terminated
  int32_t l_name;        // including the NUL
  const uint8_t* cigar;  // n_cigar uint32 ops
  int32_t n_cigar;
  const uint8_t* seq4;   // 4-bit packed, (l_seq+1)/2 bytes
  const uint8_t* qual;   // l_seq raw phred bytes (0xff = missing)
  const uint8_t* xa; int32_t xa_len;   // Z-tag payloads (w/o NUL), or null
  const uint8_t* mc; int32_t mc_len;
  const uint8_t* sa; int32_t sa_len;
  int32_t nm; bool has_nm;
  int32_t score, soft_left, clip_sum, lowq, xa_n;
};

constexpr int32_t MATCH = 2, MISMATCH = 12;
constexpr int32_t GO = 16, GE = 1, GO2 = 32, GE2 = 0;
const char kCigChr[16] = {'M','I','D','N','S','H','P','=','X','?','?','?','?','?','?','?'};
const char kNib16[16] = {'=','A','C','M','G','R','S','V','T','W','Y','H','K','D','B','N'};

inline void parse_rec(const uint8_t* b, int64_t blen, Rec& r,
                      int32_t lowq_cutoff) {
  std::memcpy(&r.tid, b + 0, 4);
  std::memcpy(&r.pos, b + 4, 4);
  r.l_name = b[8];
  r.mapq = b[9];
  uint16_t n_cigar, flag16;
  std::memcpy(&n_cigar, b + 12, 2);
  std::memcpy(&flag16, b + 14, 2);
  r.flag = flag16;
  r.n_cigar = n_cigar;
  std::memcpy(&r.l_seq, b + 16, 4);
  std::memcpy(&r.mtid, b + 20, 4);
  std::memcpy(&r.mpos, b + 24, 4);
  std::memcpy(&r.isize, b + 28, 4);
  r.name = b + 32;
  r.cigar = b + 32 + r.l_name;

  int32_t score = 0, gap = 0, soft_l = 0, soft_r = 0;
  for (int32_t k = 0; k < r.n_cigar; k++) {
    uint32_t cv;
    std::memcpy(&cv, r.cigar + 4 * k, 4);
    const int32_t ln = (int32_t)(cv >> 4);
    const int32_t op = (int32_t)(cv & 0xF);
    if (op == 0 || op == 7) {
      score += ln * MATCH;
    } else if (op == 1 || op == 2 || op == 4 || op == 5) {
      if (op == 1 || op == 2) gap += ln;
      score -= std::min(GO + ln * GE, GO2 + ln * GE2);
    }
    if (op == 4 || op == 5) {
      if (k == 0) soft_l = ln;
      if (k == r.n_cigar - 1) soft_r = ln;
    }
  }
  r.soft_left = soft_l;
  r.clip_sum = soft_l + soft_r;

  r.seq4 = r.cigar + 4 * r.n_cigar;
  r.qual = r.seq4 + (r.l_seq + 1) / 2;
  int32_t lowq = 0;
  if (r.l_seq > 0 && r.qual[0] != 0xFF) {
    // raw phred < cutoff; the reference compares '/' (47) against RAW
    // phred (bam_file.c:673-684) — 47 reproduces its behavior
    for (int32_t k = 0; k < r.l_seq; k++) lowq += (r.qual[k] < lowq_cutoff);
  }
  r.lowq = lowq;

  const uint8_t* t = r.qual + r.l_seq;
  const uint8_t* end = b + blen;
  r.nm = 0; r.has_nm = false;
  r.xa = r.mc = r.sa = nullptr;
  r.xa_len = r.mc_len = r.sa_len = 0;
  int32_t xa_semi = -1;
  while (t + 3 <= end) {
    const uint8_t t0 = t[0], t1 = t[1];
    const char ty = (char)t[2];
    t += 3;
    int64_t adv;
    switch (ty) {
      case 'A': adv = 1; break;
      case 'c': case 'C': adv = 1; break;
      case 's': case 'S': adv = 2; break;
      case 'i': case 'I': adv = 4; break;
      case 'f': adv = 4; break;
      case 'Z': case 'H': {
        const uint8_t* z = t;
        while (z < end && *z) z++;
        adv = z - t + 1;
        break;
      }
      case 'B': {
        if (t + 5 > end) { adv = end - t; break; }
        uint32_t cnt;
        std::memcpy(&cnt, t + 1, 4);
        int32_t esz;
        switch ((char)t[0]) {
          case 'c': case 'C': esz = 1; break;
          case 's': case 'S': esz = 2; break;
          default: esz = 4; break;
        }
        adv = 5 + (int64_t)cnt * esz;
        break;
      }
      default: adv = end - t; break;
    }
    if (t0 == 'N' && t1 == 'M') {
      r.has_nm = true;
      switch (ty) {
        case 'c': r.nm = *(const int8_t*)t; break;
        case 'C': r.nm = *t; break;
        case 's': { int16_t v; std::memcpy(&v, t, 2); r.nm = v; break; }
        case 'S': { uint16_t v; std::memcpy(&v, t, 2); r.nm = v; break; }
        case 'i': case 'I': std::memcpy(&r.nm, t, 4); break;
        default: r.has_nm = false; break;
      }
    } else if ((ty == 'Z' || ty == 'H')) {
      const uint8_t* z = t;
      int32_t zl = 0;
      while (z + zl < end && z[zl]) zl++;
      if (t0 == 'X' && t1 == 'A') {
        r.xa = t; r.xa_len = zl;
        xa_semi = 0;
        for (int32_t k2 = 0; k2 < zl; k2++) xa_semi += (t[k2] == ';');
      } else if (t0 == 'M' && t1 == 'C') {
        r.mc = t; r.mc_len = zl;
      } else if (t0 == 'S' && t1 == 'A') {
        r.sa = t; r.sa_len = zl;
      }
    }
    t += adv;
  }
  score -= (MISMATCH + MATCH) * (r.nm - gap);
  r.score = std::max(0, score);
  r.xa_n = (r.mapq > 0) ? 0 : (xa_semi < 0 ? 6 : xa_semi);
}

// classify_pair (signal/extract.py:289-346). Returns verdict
// (1 signal, 0 filtered, -1 full-match discard) and sets reason.
inline int32_t classify(const Rec& r1, const Rec& r2, int32_t min_isize,
                        int32_t max_isize, int32_t max_tid,
                        int32_t discard_full, int32_t not_using_filter,
                        int32_t* reason_out) {
  const int32_t isize = std::abs(r1.isize);
  const bool unm1 = r1.flag & 0x4, unm2 = r2.flag & 0x4;
  *reason_out = 0;
  if (discard_full) {
    const int32_t min_score =
        (r1.l_seq + r2.l_seq) * MATCH - 4 * (MATCH + MISMATCH);
    const bool near_full = r1.score + r2.score >= min_score;
    const bool isize_ok =
        isize != 0 && min_isize < isize && isize < max_isize;
    if (near_full && isize_ok && r1.tid == r2.tid && r1.tid <= max_tid &&
        r2.tid <= max_tid)
      return -1;
  }
  bool d0 = !(r1.flag & 0x10), d1 = !(r2.flag & 0x10);
  if (r1.pos > r2.pos) std::swap(d0, d1);
  if (isize == r1.l_seq && isize == r2.l_seq && !d0 && d1) std::swap(d0, d1);
  int32_t clip[2] = {r1.clip_sum, r2.clip_sum};
  int32_t lowq[2] = {r1.lowq, r2.lowq};
  int32_t indel[2] = {r1.nm, r2.nm};
  for (int32_t k = 0; k < 2; k++) {
    clip[k] -= lowq[k];
    if (clip[k] < 0) { lowq[k] = -clip[k]; clip[k] = 0; }
    lowq[k] >>= 1;
    indel[k] -= lowq[k];
    if (indel[k] < 0) indel[k] = 0;
  }
  int32_t rs = 0;
  if (r1.mapq < 10 && r2.mapq < 10) rs += 1;
  if (unm1 || unm2) rs += 2;
  if (isize > 1000) rs += 4;
  if (!d0 || d1) rs += 8;
  if (indel[0] + indel[1] > 15) rs += 16;
  if (clip[0] + clip[1] > 10) rs += 32;
  if (r1.tid != r2.tid || r1.tid > max_tid || r2.tid > max_tid) rs += 64;
  *reason_out = rs;
  return (rs != 0 || not_using_filter) ? 1 : 0;
}

inline void put_i(std::string& s, int64_t v) {
  char tmp[24];
  int n = std::snprintf(tmp, sizeof tmp, "%lld", (long long)v);
  s.append(tmp, n);
}

// one mate's FASTQ entry (extract._pair_comment + _fastq_entry)
inline void render_one(const Rec& a, const Rec& b, int32_t abs_isize1,
                       bool with_stat, int32_t st_rl, int32_t st_min,
                       int32_t st_mid, int32_t st_max, std::string& out) {
  out.push_back('@');
  out.append((const char*)a.name, a.l_name > 0 ? a.l_name - 1 : 0);
  out.push_back(' ');
  put_i(out, a.tid); out.push_back('_');
  put_i(out, a.pos); out.push_back('_');
  put_i(out, a.soft_left); out.push_back('_');
  put_i(out, a.score); out.push_back('_');
  put_i(out, a.mapq); out.push_back('_');
  put_i(out, b.mapq); out.push_back('_');
  put_i(out, a.xa_n); out.push_back('_');
  put_i(out, b.xa_n); out.push_back('_');
  put_i(out, abs_isize1); out.push_back('_');
  for (const Rec* r : {&a, &b}) {
    out.push_back((r->flag & 0x10) ? 'R' : 'F');
    out.push_back((r->flag & 0x4) ? 'Y' : 'N');
    out.push_back(r->nm > 8 ? 'Y' : 'N');
    out.push_back(r->clip_sum > 10 ? 'Y' : 'N');
    out.push_back('_');
  }
  if (with_stat) {
    out.append("STAT_");
    put_i(out, st_rl); out.push_back('_');
    put_i(out, st_min); out.push_back('_');
    put_i(out, st_mid); out.push_back('_');
    put_i(out, st_max); out.push_back('_');
  }
  out.append("FLAG_");
  put_i(out, a.flag); out.push_back('_');
  put_i(out, a.mapq); out.append("_CIGAR_");
  for (int32_t k = 0; k < a.n_cigar; k++) {
    uint32_t cv;
    std::memcpy(&cv, a.cigar + 4 * k, 4);
    put_i(out, (int64_t)(cv >> 4));
    out.push_back(kCigChr[cv & 0xF]);
  }
  out.append("_MATE_");
  put_i(out, a.mtid); out.push_back('_');
  put_i(out, a.mpos); out.push_back('_');
  put_i(out, a.isize); out.append("_TAG_");
  if (a.xa) { out.append("XA:Z:"); out.append((const char*)a.xa, a.xa_len); out.push_back('_'); }
  if (a.mc) { out.append("MC:Z:"); out.append((const char*)a.mc, a.mc_len); out.push_back('_'); }
  if (a.sa) { out.append("SA:Z:"); out.append((const char*)a.sa, a.sa_len); out.push_back('_'); }
  if (a.has_nm) { out.append("NM:i:"); put_i(out, a.nm); out.push_back('_'); }
  out.push_back('\n');

  // sequence (nib16 decode; revcomp when mapped & reverse — the
  // complement maps every non-ACGT nib16 char to 'N', matching
  // utils/dna.py revcomp's encode/complement/decode chain)
  const bool rc = !(a.flag & 0x4) && (a.flag & 0x10);
  const size_t seq_at = out.size();
  out.resize(seq_at + a.l_seq);
  char* sp = &out[seq_at];
  if (rc) {
    for (int32_t k = 0; k < a.l_seq; k++) {
      const int32_t src = a.l_seq - 1 - k;
      const uint8_t nib = (src & 1) ? (a.seq4[src >> 1] & 0xF)
                                    : (a.seq4[src >> 1] >> 4);
      const char c = kNib16[nib];
      sp[k] = (c == 'A') ? 'T' : (c == 'C') ? 'G' : (c == 'G') ? 'C'
              : (c == 'T') ? 'A' : 'N';
    }
  } else {
    for (int32_t k = 0; k < a.l_seq; k++) {
      const uint8_t nib = (k & 1) ? (a.seq4[k >> 1] & 0xF)
                                  : (a.seq4[k >> 1] >> 4);
      sp[k] = kNib16[nib];
    }
  }
  out.append("\n+\n");
  const size_t q_at = out.size();
  out.resize(q_at + a.l_seq);
  char* qp = &out[q_at];
  const bool q_missing = a.l_seq == 0 || a.qual[0] == 0xFF;
  if (q_missing) {
    std::memset(qp, 'I', a.l_seq);
  } else if (rc) {
    for (int32_t k = 0; k < a.l_seq; k++) {
      const uint8_t q = a.qual[a.l_seq - 1 - k];
      qp[k] = (char)((q > 93 ? 93 : q) + 33);
    }
  } else {
    for (int32_t k = 0; k < a.l_seq; k++) {
      const uint8_t q = a.qual[k];
      qp[k] = (char)((q > 93 ? 93 : q) + 33);
    }
  }
  out.push_back('\n');
}

struct RenderCtx {
  std::string fq;
};

}  // namespace sigr

// mode 0: positional in-block pairing; mode 1: adjacent-by-name pairing
// of pre-sorted phase-2 leftovers. Returns a handle to fetch/free the
// rendered FASTQ via glue_signal_fq_fetch.
extern "C" void* glue_signal_render(
    const uint8_t* blob, const int64_t* offs, const int32_t* lens,
    int32_t n, int32_t mode, int32_t min_isize, int32_t max_isize,
    int32_t max_tid, int32_t discard_full, int32_t not_using_filter,
    int32_t lowq_cutoff,
    int32_t emit_stat, int32_t st_rl, int32_t st_min, int32_t st_mid,
    int32_t st_max, int32_t n_threads, int64_t* out_fq_len,
    int32_t* out_n_pairs, int32_t* out_n_signal, int32_t* out_stat_emitted,
    int32_t* leftover_idx, int32_t* out_n_leftover,
    int64_t* reason_counts /* 1024, += */) {
  using sigr::Rec;
  std::vector<Rec> rec(n);
  {
    std::atomic<int32_t> next{0};
    auto work = [&]() {
      for (;;) {
        const int32_t i = next.fetch_add(256);
        if (i >= n) return;
        const int32_t e = std::min(i + 256, n);
        for (int32_t k = i; k < e; k++)
          sigr::parse_rec(blob + offs[k], lens[k], rec[k], lowq_cutoff);
      }
    };
    if (n_threads > 1 && n > 512) {
      std::vector<std::thread> ts;
      for (int t = 0; t < n_threads; t++) ts.emplace_back(work);
      for (auto& t : ts) t.join();
    } else {
      work();
    }
  }

  // ---- pairing ----------------------------------------------------------
  std::vector<int32_t> mate(n, -1);
  std::vector<std::pair<int32_t, int32_t>> pairs;  // (r1 idx, r2 idx)
  int32_t n_leftover = 0;
  if (mode == 0) {
    std::unordered_map<int32_t, std::vector<int32_t>> by_pos;
    by_pos.reserve((size_t)n * 2);
    for (int32_t k = 0; k < n; k++) by_pos[rec[k].pos].push_back(k);
    for (int32_t i = 0; i < n; i++) {
      if (mate[i] >= 0) continue;
      const Rec& r = rec[i];
      if (r.tid != r.mtid) continue;
      if (r.tid == -1) {
        for (int32_t d = 0; d < 2; d++) {
          const int32_t k = (d == 0) ? i + 1 : i - 1;
          if (k >= 0 && k < n && mate[k] < 0 &&
              std::strcmp((const char*)rec[k].name, (const char*)r.name) == 0) {
            mate[i] = k;
            mate[k] = i;
            break;
          }
        }
        continue;
      }
      auto it = by_pos.find(r.mpos);
      if (it == by_pos.end()) continue;
      for (const int32_t k : it->second) {
        const Rec& m = rec[k];
        if (k != i && m.mpos == r.pos && mate[k] < 0 &&
            std::strcmp((const char*)m.name, (const char*)r.name) == 0) {
          mate[i] = k;
          mate[k] = i;
          break;
        }
      }
    }
    for (int32_t i = 0; i < n; i++)
      if (mate[i] < 0) leftover_idx[n_leftover++] = i;
    for (int32_t i = 0; i < n; i++) {
      if (mate[i] < 0) continue;
      if (!(rec[i].flag & 0x40)) continue;
      if (rec[mate[i]].flag & 0x40) continue;
      pairs.push_back({i, mate[i]});
    }
  } else {
    int32_t i = 0;
    while (i + 1 < n) {
      if (std::strcmp((const char*)rec[i].name,
                      (const char*)rec[i + 1].name) == 0) {
        int32_t a = i, c = i + 1;
        if (!(rec[a].flag & 0x40)) std::swap(a, c);
        pairs.push_back({a, c});
        i += 2;
      } else {
        i += 1;
      }
    }
  }
  *out_n_leftover = n_leftover;

  // ---- classify (sequential: counters + STAT position) -------------------
  std::vector<int32_t> emit;   // indices into `pairs` marked signal
  int32_t n_pairs = 0;
  for (size_t p = 0; p < pairs.size(); p++) {
    const Rec& r1 = rec[pairs[p].first];
    const Rec& r2 = rec[pairs[p].second];
    n_pairs++;
    int32_t rs = 0;
    const int32_t v = sigr::classify(r1, r2, min_isize, max_isize, max_tid,
                                     discard_full, not_using_filter, &rs);
    if (v == -1) continue;
    reason_counts[rs & 1023]++;
    if (v == 1) emit.push_back((int32_t)p);
  }
  *out_n_pairs = n_pairs;
  *out_n_signal = (int32_t)emit.size();
  *out_stat_emitted = (emit_stat && !emit.empty()) ? 1 : 0;

  // ---- render (parallel over contiguous emit ranges) ---------------------
  auto* ctx = new sigr::RenderCtx();
  const int32_t ne = (int32_t)emit.size();
  const int T = (n_threads > 1 && ne > 64)
                    ? std::min<int>(n_threads, 8) : 1;
  std::vector<std::string> parts(T);
  {
    std::vector<std::thread> ts;
    auto work = [&](int t) {
      const int32_t lo = (int32_t)((int64_t)ne * t / T);
      const int32_t hi = (int32_t)((int64_t)ne * (t + 1) / T);
      std::string& o = parts[t];
      for (int32_t e = lo; e < hi; e++) {
        const auto& pr = pairs[emit[e]];
        const Rec& r1 = rec[pr.first];
        const Rec& r2 = rec[pr.second];
        const int32_t ai = std::abs(r1.isize);
        const bool ws = emit_stat && e == 0;
        sigr::render_one(r1, r2, ai, ws, st_rl, st_min, st_mid, st_max, o);
        sigr::render_one(r2, r1, ai, false, st_rl, st_min, st_mid, st_max, o);
      }
    };
    if (T > 1) {
      for (int t = 0; t < T; t++) ts.emplace_back(work, t);
      for (auto& t : ts) t.join();
    } else {
      work(0);
    }
  }
  size_t total = 0;
  for (auto& s : parts) total += s.size();
  ctx->fq.reserve(total);
  for (auto& s : parts) ctx->fq += s;
  *out_fq_len = (int64_t)ctx->fq.size();
  return ctx;
}

extern "C" void glue_signal_fq_fetch(void* vctx, uint8_t* dst) {
  auto* ctx = (sigr::RenderCtx*)vctx;
  std::memcpy(dst, ctx->fq.data(), ctx->fq.size());
  delete ctx;
}

// Record-boundary scan over a decompressed BAM byte stream: walks the
// int32 size prefixes and emits per-record (body offset, body length,
// tid, pos, flag, l_seq, tlen) columns so Python's streaming passes
// (fc_signal blocking, stats histograms) are pure NumPy over columns
// instead of a per-record interpreter loop. Returns the record count;
// *consumed is the byte length of complete records (the tail beyond it
// carries into the next chunk).
extern "C" int32_t glue_bam_scan(const uint8_t* data, int64_t len,
                                 int32_t max_records, int64_t* consumed,
                                 int64_t* offs, int32_t* lens,
                                 int32_t* tid, int32_t* pos, int32_t* flag,
                                 int32_t* l_seq, int32_t* tlen) {
  int64_t p = 0;
  int32_t n = 0;
  while (n < max_records && p + 4 <= len) {
    uint32_t sz;
    std::memcpy(&sz, data + p, 4);
    if (p + 4 + (int64_t)sz > len) break;
    const uint8_t* b = data + p + 4;
    offs[n] = p + 4;
    lens[n] = (int32_t)sz;
    std::memcpy(&tid[n], b, 4);
    std::memcpy(&pos[n], b + 4, 4);
    flag[n] = (int32_t)b[14] | ((int32_t)b[15] << 8);
    std::memcpy(&l_seq[n], b + 16, 4);
    std::memcpy(&tlen[n], b + 28, 4);
    p += 4 + sz;
    n++;
  }
  *consumed = p;
  return n;
}

// ---------------------------------------------------------------------
// Native PE pairing + realigned-BAM emission.
//
// After glue_replay, the per-read results (scores, positions, cigars)
// already live in the Ctx; this pass runs the whole Python tail —
// PEScorer.pair (host_align.py:596-628, the reference's
// read_get_best_pairing_results, read_realignment.hpp:476-500),
// emit_pair/make_bam_record (bam_out.py:29-135, reference output_BAM
// read_realignment.cpp:479-536) and the BAM record encoder
// (io/bam.py:_encode_record) — in C++, producing one contiguous blob
// of encoded record bodies per batch. Byte-identical to the Python
// path (tests/test_native_emit.py).
//
// Pairs whose reads took the host-fallback path (their results are not
// in the Ctx) arrive pre-encoded from Python through skip_blob and are
// spliced in pair order, so record order matches the Python emitter.

namespace emitN {

struct Cand {
  bool is_ori;
  int32_t align_score, chain_score, read_bg, mapq, ref_bg, dir;
  int32_t sv_id;     // -1 for ori
  int32_t rst_idx;   // result rank (new results)
  int32_t chr_raw;   // ori.chr_id for ori; -1 for new (device-path quirk)
  int32_t tid;       // resolved output header tid
  int32_t key;       // interned chrom-name key for proper-mating
  int32_t res_x;     // index into ctx res arrays (-1 = ori candidate)
};

struct EmitIn {
  const int32_t* ori8;
  const uint8_t *name_blob, *seq_blob, *qual_blob, *comment_blob;
  const int64_t *name_off, *seq_off, *qual_off, *comment_off;
  const int32_t *sv_tid, *sv_end_off, *sv_key, *ori_tid, *ori_key;
  const uint8_t* svtag_blob;
  const int64_t* svtag_off;
  const uint8_t* vcfid_blob;
  const int64_t* vcfid_off;
  int32_t n_ori_chr;
  int32_t max_isize, min_isize, normal_read_len;
};

static inline int32_t end_off(const EmitIn& in, const Cand* c) {
  return (c->is_ori || c->sv_id < 0) ? 0 : in.sv_end_off[c->sv_id];
}

static inline int get_isize(const EmitIn& in, int64_t p1, int64_t p2,
                            int d1, int d2) {
  if (d1 == d2) return 0;
  int64_t is = in.normal_read_len + ((d1 == 0) ? (p2 - p1) : (p1 - p2));
  return (is > in.min_isize && is < in.max_isize) ? (int)is : 0;
}

static inline int proper_mated(const EmitIn& in, const Cand* a,
                               const Cand* b) {
  if (!a || !b) return 0;
  if (a->key != b->key) return 0;
  int64_t p1a = a->ref_bg, p1b = p1a + end_off(in, a);
  int64_t p2a = b->ref_bg, p2b = p2a + end_off(in, b);
  int is;
  if ((is = get_isize(in, p1a, p2a, a->dir, b->dir)) > 0) return is;
  if ((is = get_isize(in, p1a, p2b, a->dir, b->dir)) > 0) return is;
  if ((is = get_isize(in, p1b, p2a, a->dir, b->dir)) > 0) return is;
  if ((is = get_isize(in, p1b, p2b, a->dir, b->dir)) > 0) return is;
  return 0;
}

struct Best {
  const Cand* c1 = nullptr;
  const Cand* c2 = nullptr;
  int32_t max_score = 0;
  int32_t isize = 0;
};

static inline void store_score(const EmitIn& in, Best& best, const Cand* a,
                               const Cand* b) {
  int isize = proper_mated(in, a, b);
  int basic = (a ? a->align_score : 0) + (b ? b->align_score : 0);
  int fin = basic + (isize > 0 ? 0 : -60) +
            (((a && !a->is_ori) || (b && !b->is_ori)) ? 0 : 1);
  if (fin >= best.max_score) {
    best.c1 = a;
    best.c2 = b;
    best.max_score = fin;
    best.isize = isize;
  }
}

// 4-bit nibble per base byte (io/bam.py _SEQ16_CODE_TRANS)
static const char SEQ_NT16[] = "=ACMGRSVTWYHKDBN";
struct NibTabs {
  uint8_t fwd[256];
  uint8_t rc[256];   // nibble of the dna.revcomp()'d character
  NibTabs() {
    for (int i = 0; i < 256; i++) fwd[i] = 15;
    for (int i = 0; i < 16; i++) {
      fwd[(uint8_t)SEQ_NT16[i]] = (uint8_t)i;
      fwd[(uint8_t)std::tolower(SEQ_NT16[i])] = (uint8_t)i;
    }
    // dna.revcomp maps byte -> code (ACGT either case, else N) ->
    // complement -> "ACGTN"; everything non-ACGT becomes N
    for (int i = 0; i < 256; i++) rc[i] = 15;
    const char* b = "ACGT";
    const uint8_t comp_nib[4] = {8, 4, 2, 1};  // T G C A
    for (int i = 0; i < 4; i++) {
      rc[(uint8_t)b[i]] = comp_nib[i];
      rc[(uint8_t)std::tolower(b[i])] = comp_nib[i];
    }
  }
};
static const NibTabs NIB;

struct RecBuf {
  std::vector<uint8_t>& out;
  size_t body_start = 0;
  void begin() {
    body_start = out.size();
    out.insert(out.end(), 4, 0);  // block_size placeholder
  }
  void end() {
    uint32_t sz = (uint32_t)(out.size() - body_start - 4);
    std::memcpy(out.data() + body_start, &sz, 4);
  }
  void u8(uint8_t v) { out.push_back(v); }
  void u16(uint16_t v) {
    out.push_back((uint8_t)v);
    out.push_back((uint8_t)(v >> 8));
  }
  void i32(int32_t v) {
    uint8_t b[4];
    std::memcpy(b, &v, 4);
    out.insert(out.end(), b, b + 4);
  }
  void raw(const uint8_t* p, size_t n) { out.insert(out.end(), p, p + n); }
  void tag_i(const char* t, int32_t v) {
    out.push_back((uint8_t)t[0]);
    out.push_back((uint8_t)t[1]);
    out.push_back('i');
    i32(v);
  }
  void tag_z(const char* t, const char* s, size_t n) {
    out.push_back((uint8_t)t[0]);
    out.push_back((uint8_t)t[1]);
    out.push_back('Z');
    raw((const uint8_t*)s, n);
    out.push_back(0);
  }
};

}  // namespace emitN

extern "C" int64_t glue_pe_emit(
    void* vctx, int32_t n, const int32_t* ori8, const uint8_t* name_blob,
    const int64_t* name_off, const uint8_t* seq_blob, const int64_t* seq_off,
    const uint8_t* qual_blob, const int64_t* qual_off,
    const uint8_t* comment_blob, const int64_t* comment_off,
    const int32_t* sv_tid, const int32_t* sv_end_off, const int32_t* sv_key,
    const uint8_t* svtag_blob, const int64_t* svtag_off,
    const uint8_t* vcfid_blob, const int64_t* vcfid_off,
    const int32_t* ori_tid, const int32_t* ori_key, int32_t n_ori_chr,
    int32_t max_isize, int32_t min_isize, int32_t normal_read_len,
    const uint8_t* skip_blob, const int64_t* skip_off) {
  using namespace emitN;
  Ctx* ctx = (Ctx*)vctx;
  EmitIn in{ori8,   name_blob, seq_blob, qual_blob, comment_blob,
            name_off, seq_off,  qual_off, comment_off,
            sv_tid, sv_end_off, sv_key,   ori_tid,  ori_key,
            svtag_blob, svtag_off, vcfid_blob, vcfid_off,
            n_ori_chr, max_isize, min_isize, normal_read_len};

  // res span per read (res_read is non-decreasing)
  std::vector<std::pair<int32_t, int32_t>> span(ctx->n_pad, {0, 0});
  {
    size_t x = 0;
    while (x < ctx->res_read.size()) {
      int32_t r = ctx->res_read[x];
      size_t e = x;
      while (e < ctx->res_read.size() && ctx->res_read[e] == r) e++;
      if (r >= 0 && r < ctx->n_pad)
        span[r] = {(int32_t)x, (int32_t)e};
      x = e;
    }
  }

  ctx->emit_buf.clear();
  RecBuf rb{ctx->emit_buf};
  std::vector<Cand> c1v, c2v;

  auto build_cands = [&](int32_t i, std::vector<Cand>& v) {
    v.clear();
    const int32_t* o = ori8 + (int64_t)i * 8;
    auto [lo, hi] = span[i];
    for (int32_t x = lo; x < hi; x++) {
      const int32_t* f = ctx->res_fields.data() + (int64_t)x * 8;
      Cand c;
      c.is_ori = false;
      c.dir = f[0];
      c.chain_score = f[1];
      c.align_score = f[2];
      c.read_bg = f[3];
      c.ref_bg = f[4];
      c.sv_id = f[5];
      c.mapq = f[6];
      c.rst_idx = f[7];
      c.chr_raw = -1;
      c.tid = c.sv_id >= 0 ? sv_tid[c.sv_id] : -1;
      c.key = c.sv_id >= 0 ? sv_key[c.sv_id] : -3;
      c.res_x = x;
      v.push_back(c);
    }
    if (!o[6]) {  // not ori_unmapped -> ori is a pairing candidate
      Cand c;
      c.is_ori = true;
      c.align_score = o[3];
      c.chain_score = 0;
      c.read_bg = o[2];
      c.mapq = o[4];
      c.ref_bg = o[1];
      c.dir = o[5];
      c.sv_id = -1;
      c.rst_idx = -1;
      c.chr_raw = o[0];
      bool in_range = o[0] >= 0 && o[0] < n_ori_chr;
      c.tid = in_range ? ori_tid[o[0]] : -1;
      c.key = in_range ? ori_key[o[0]] : -2;
      c.res_x = -1;
      v.push_back(c);
    }
  };

  auto emit_end = [&](bool is_first, int32_t i, const Cand* primary,
                      const Cand* mate, const std::vector<Cand>& cands,
                      int32_t abs_isize) {
    if (!primary) return;
    const int32_t* o = ori8 + (int64_t)i * 8;
    // secondary selection (bam_out.emit_pair:123-128); new results sit
    // at the head of `cands` in rank order, ori (if any) is last
    int32_t n_new = (int32_t)cands.size() - (cands.empty() || !cands.back().is_ori ? 0 : 1);
    const Cand* secondary = nullptr;
    if (primary->is_ori && n_new > 0)
      secondary = &cands[0];
    else if (n_new > 1 && !primary->is_ori)
      secondary = primary->rst_idx == 0 ? &cands[1] : &cands[0];

    uint16_t flag = is_first ? 0x40 : 0;
    if (primary->dir == 1) flag |= 0x10;
    if (!mate) flag |= 0x8;

    // SV info channel: own for new primaries, the mate's for ori ones
    int32_t sv_of_rec = -1;
    int32_t tid;
    if (primary->is_ori) {
      tid = primary->tid;
      if (mate && !mate->is_ori) sv_of_rec = mate->sv_id;
    } else {
      sv_of_rec = primary->sv_id;
      tid = primary->tid;
    }

    const uint8_t* name = name_blob + name_off[i];
    int32_t name_l = (int32_t)(name_off[i + 1] - name_off[i]);
    const uint8_t* seq = seq_blob + seq_off[i];
    int32_t l_seq = (int32_t)(seq_off[i + 1] - seq_off[i]);
    const uint8_t* qual = qual_blob + qual_off[i];
    int32_t qual_l = (int32_t)(qual_off[i + 1] - qual_off[i]);

    // cigar runs: from the ctx result, or the ori's clip+match shape
    const uint8_t* cig_op = nullptr;
    const int32_t* cig_len = nullptr;
    int32_t n_cig;
    uint32_t ori_cig[2];
    uint32_t ncig_buf[2];
    if (primary->res_x >= 0) {
      int32_t off = ctx->res_cig_off[primary->res_x];
      n_cig = ctx->res_cig_n[primary->res_x];
      cig_op = ctx->out_cig_op.data() + off;
      cig_len = (const int32_t*)ctx->out_cig_len.data() + off;
    } else {
      // [S read_bg][M l_seq-read_bg] (host_align._ori_as_result)
      n_cig = 0;
      if (primary->read_bg > 0)
        ori_cig[n_cig++] = ((uint32_t)primary->read_bg << 4) | 4;
      ori_cig[n_cig++] =
          ((uint32_t)(l_seq - primary->read_bg) << 4) | 0;
      (void)ncig_buf;
    }

    rb.begin();
    rb.i32(tid);
    rb.i32(primary->ref_bg);
    rb.u8((uint8_t)(name_l + 1));
    rb.u8((uint8_t)primary->mapq);
    rb.u16(0);  // bin (io/bam.py leaves 0)
    rb.u16((uint16_t)n_cig);
    rb.u16(flag);
    rb.i32(l_seq);
    rb.i32(mate ? mate->tid : -1);
    rb.i32(mate ? mate->ref_bg : -1);
    rb.i32(primary->dir == 0 ? abs_isize : -abs_isize);
    rb.raw(name, name_l);
    rb.u8(0);
    if (primary->res_x >= 0) {
      for (int32_t k = 0; k < n_cig; k++) {
        // ctx ops are 0=M 1=I 2=D, equal to the BAM op codes
        uint32_t w = ((uint32_t)cig_len[k] << 4) | cig_op[k];
        rb.i32((int32_t)w);
      }
    } else {
      for (int32_t k = 0; k < n_cig; k++) rb.i32((int32_t)ori_cig[k]);
    }
    // seq nibbles (forward or revcomp per direction)
    {
      size_t at = rb.out.size();
      rb.out.resize(at + (l_seq + 1) / 2, 0);
      uint8_t* dst = rb.out.data() + at;
      if (primary->dir == 0) {
        for (int32_t k = 0; k < l_seq; k++) {
          uint8_t nib = NIB.fwd[seq[k]];
          dst[k >> 1] |= (k & 1) ? nib : (uint8_t)(nib << 4);
        }
      } else {
        for (int32_t k = 0; k < l_seq; k++) {
          uint8_t nib = NIB.rc[seq[l_seq - 1 - k]];
          dst[k >> 1] |= (k & 1) ? nib : (uint8_t)(nib << 4);
        }
      }
    }
    // qual (phred+33 -> raw, reversed for reverse strand)
    {
      size_t at = rb.out.size();
      rb.out.resize(at + l_seq);
      uint8_t* dst = rb.out.data() + at;
      if (qual_l != l_seq) {
        std::memset(dst, 0xFF, l_seq);
      } else if (primary->dir == 0) {
        for (int32_t k = 0; k < l_seq; k++) {
          uint8_t v = (uint8_t)(qual[k] - 33);
          dst[k] = v > 93 ? 93 : v;
        }
      } else {
        for (int32_t k = 0; k < l_seq; k++) {
          uint8_t v = (uint8_t)(qual[l_seq - 1 - k] - 33);
          dst[k] = v > 93 ? 93 : v;
        }
      }
    }
    // tags in make_bam_record order: AS OS OA [CS] [SV] [MV] [XA] RC
    rb.tag_i("AS", primary->align_score);
    rb.tag_i("OS", o[3]);
    {
      char oa[96];
      int m = snprintf(oa, sizeof oa, "%d,%d,%d,%d,%c;", o[0], o[1], o[2],
                       o[4], o[6] ? 'U' : 'M');
      rb.tag_z("OA", oa, (size_t)m);
    }
    if (!primary->is_ori) rb.tag_i("CS", primary->chain_score);
    if (sv_of_rec >= 0)
      rb.tag_z("SV", (const char*)svtag_blob + svtag_off[sv_of_rec],
               (size_t)(svtag_off[sv_of_rec + 1] - svtag_off[sv_of_rec]));
    if (mate && !mate->is_ori && mate->sv_id >= 0)
      rb.tag_z("MV", (const char*)svtag_blob + svtag_off[mate->sv_id],
               (size_t)(svtag_off[mate->sv_id + 1] - svtag_off[mate->sv_id]));
    if (secondary) {
      char xa[512];
      int m;
      if (secondary->sv_id >= 0) {
        int vl = (int)(vcfid_off[secondary->sv_id + 1] -
                       vcfid_off[secondary->sv_id]);
        m = snprintf(xa, sizeof xa, "%d,%d,%d,%d,%c,%.*s;",
                     secondary->chr_raw, secondary->ref_bg,
                     secondary->read_bg, secondary->align_score,
                     secondary->dir == 0 ? 'F' : 'R', vl,
                     (const char*)vcfid_blob + vcfid_off[secondary->sv_id]);
      } else {
        m = snprintf(xa, sizeof xa, "%d,%d,%d,%d,%c,*;",
                     secondary->chr_raw, secondary->ref_bg,
                     secondary->read_bg, secondary->align_score,
                     secondary->dir == 0 ? 'F' : 'R');
      }
      if (m > (int)sizeof xa - 1) m = (int)sizeof xa - 1;
      rb.tag_z("XA", xa, (size_t)m);
    }
    rb.tag_z("RC", (const char*)comment_blob + comment_off[i],
             (size_t)(comment_off[i + 1] - comment_off[i]));
    rb.end();
  };

  for (int32_t k = 0; k + 1 < n; k += 2) {
    int32_t p = k / 2;
    if (skip_off[p + 1] > skip_off[p]) {  // Python-encoded fallback pair
      ctx->emit_buf.insert(ctx->emit_buf.end(), skip_blob + skip_off[p],
                           skip_blob + skip_off[p + 1]);
      continue;
    }
    if (ori8[(int64_t)k * 8 + 7]) continue;  // empty skipped pair
    build_cands(k, c1v);
    build_cands(k + 1, c2v);
    Best best;
    for (const Cand& a : c1v) store_score(in, best, &a, nullptr);
    for (const Cand& b : c2v) store_score(in, best, nullptr, &b);
    for (const Cand& a : c1v)
      for (const Cand& b : c2v) store_score(in, best, &a, &b);
    bool gain = best.max_score > 0 &&
                ((best.c1 && !best.c1->is_ori) || (best.c2 && !best.c2->is_ori));
    if (!gain) continue;
    int32_t abs_isize = best.isize < 0 ? -best.isize : best.isize;
    emit_end(true, k, best.c1, best.c2, c1v, abs_isize);
    emit_end(false, k + 1, best.c2, best.c1, c2v, abs_isize);
  }
  return (int64_t)ctx->emit_buf.size();
}

extern "C" void glue_emit_fetch(void* vctx, uint8_t* dst) {
  Ctx* ctx = (Ctx*)vctx;
  std::memcpy(dst, ctx->emit_buf.data(), ctx->emit_buf.size());
}

// Parse signal-FASTQ comments into (n, 8) int32 ori rows:
// [chr_id, ref_bg, read_bg, align_score, mapq, direction, unmapped, 0]
// — the first five '_' fields plus the flags field (index 9) of the
// comment grammar (parse_ori_mapping_rst, read_realignment.hpp:392-429;
// pipeline.parse_signal_comment is the Python twin). Replaces ~8 us of
// Python string splitting per read on the fc_aln hot path.
extern "C" void glue_parse_comments(const uint8_t* blob, const int64_t* offs,
                                    int32_t n, int32_t* out8) {
  for (int32_t i = 0; i < n; i++) {
    const char* s = (const char*)blob + offs[i];
    const char* e = (const char*)blob + offs[i + 1];
    int32_t* o = out8 + (int64_t)i * 8;
    for (int k = 0; k < 8; k++) o[k] = 0;
    int field = 0;
    while (s < e && field <= 9) {
      const char* f = s;
      while (s < e && *s != '_') s++;
      if (field <= 4) {
        bool neg = f < s && *f == '-';
        int64_t v = 0;
        for (const char* c = f + (neg ? 1 : 0); c < s; c++)
          if (*c >= '0' && *c <= '9') v = v * 10 + (*c - '0');
        o[field] = (int32_t)(neg ? -v : v);
      } else if (field == 9) {
        o[5] = (f < s && f[0] == 'F') ? 0 : 1;
        o[6] = (f + 1 < s && f[1] == 'Y') ? 1 : 0;
      }
      field++;
      s++;
    }
  }
}

// ---------------------------------------------------------------------
// Native insert-size statistics scan (stage fc_signal pass 1).
//
// C++ port of the repo's OWN Manta-derived StatsManager.handle_bam hot
// loop (pansvr_tpu/signal/stats_manager.py:131-312; reference spec:
// StatsManager.cpp:143-222, StatsTracker.cpp) — the per-record Python
// loop is ~85% of fc_signal wall. Semantics are replicated exactly:
// region sampling from each chromosome's 20% point, 1000-observation
// buffers rejected when >=1% abnormal (skip ahead chrom/100),
// getSimplifiedFragSize 4-digit rounding, 1000-bin CDF quantiles with
// round-half-even (np.rint == nearbyint under FE_TONEAREST), and the
// 100k-observation convergence test (quantile equality at
// p=0.05,0.15,..,0.95). The caller exports the full tracker state and
// finishes (finalize + quantile queries) in Python, so the status
// output stays byte-identical to the Python path (tested).

namespace statsN {

constexpr int64_t kStatsCheckCnt = 100000;
constexpr int32_t kBufferFull = 1000;
constexpr int32_t kAbnormalSize = 5000;
constexpr double kAbnormalFrac = 0.01;
constexpr int32_t kQuantileNum = 1000;

static int32_t simplified_frag(int64_t frag) {
  int steps = 0;
  while (frag > 1000) {
    frag /= 10;
    steps++;
  }
  for (int i = 0; i < steps; i++) frag *= 10;
  return (int32_t)frag;
}

struct Dist {
  std::map<int32_t, int64_t> counts;
  int64_t total = 0;

  void calc(int32_t q[kQuantileNum]) const {
    int fill = 0;
    int64_t cum = 0;
    for (int i = 0; i < kQuantileNum; i++) q[i] = 0;
    for (const auto& kv : counts) {
      cum += kv.second;
      double cprob = (double)cum / (double)total;
      int fill_next = (int)std::nearbyint(cprob * kQuantileNum);
      if (fill_next > fill) {
        for (int i = fill; i < fill_next && i < kQuantileNum; i++)
          q[i] = kv.first;
        fill = fill_next > kQuantileNum ? kQuantileNum : fill_next;
      }
    }
    for (int i = fill; i < kQuantileNum; i++)
      q[i] = fill ? q[fill - 1] : 0;
  }

  static int32_t quantile_at(const int32_t q[kQuantileNum], double prob) {
    int b = (int)std::ceil(prob * kQuantileNum) - 1;
    if (b < 0) b = 0;
    if (b > kQuantileNum - 1) b = kQuantileNum - 1;
    return q[b];
  }
};

struct StatsCtx {
  std::vector<int64_t> ref_lens;
  std::vector<int64_t> start_at;    // 20% sampling start per tid
  std::vector<int64_t> skip_until;  // BREAK skip-ahead per tid
  Dist frag;
  // counters (ReadCounter)
  int64_t c_total = 0, c_paired = 0, c_unpaired = 0, c_lowq = 0, c_hc = 0;
  // buffer
  std::vector<int32_t> buf_sizes;
  int64_t buf_rp = 0, buf_abn = 0;
  bool checked = false, converged = false, has_old = false;
  int32_t old_q[kQuantileNum];
  // depth
  int64_t total_base = 0;
  std::vector<int64_t> span_lo, span_hi;  // -1 = unset
  std::vector<uint8_t> span_set;

  explicit StatsCtx(const int64_t* lens, int32_t n)
      : ref_lens(lens, lens + n),
        start_at(n),
        skip_until(n, 0),
        span_lo(n, 0),
        span_hi(n, 0),
        span_set(n, 0) {
    for (int32_t i = 0; i < n; i++)
      start_at[i] = (int64_t)((double)lens[i] * 0.2);
  }

  void add_buffered() {
    for (int32_t s : buf_sizes) {
      frag.counts[s]++;
      frag.total++;
      c_hc++;
    }
    if (frag.total >= kStatsCheckCnt) checked = true;
  }

  void clear_buffer() {
    buf_sizes.clear();
    buf_rp = 0;
    buf_abn = 0;
  }

  void convergence_test() {
    if (has_old) {
      int32_t q[kQuantileNum];
      frag.calc(q);
      bool match = true;
      for (double p = 0.05; p < 1; p += 0.1) {
        int32_t a = Dist::quantile_at(q, p);
        int32_t b = Dist::quantile_at(old_q, p);
        if ((a > b ? a - b : b - a) >= 1) {
          match = false;
          break;
        }
      }
      if (match) {
        converged = true;
        return;
      }
    }
    frag.calc(old_q);
    has_old = true;
    checked = false;  // wait for the next 100k before re-test
  }
};

}  // namespace statsN

extern "C" void* glue_stats_create(const int64_t* ref_lens, int32_t n_refs) {
  return new statsN::StatsCtx(ref_lens, n_refs);
}

// Walks raw decompressed BAM records ([u32 size][body]...) and feeds
// the tracker. Returns bytes consumed (a trailing partial record is
// left for the caller's carry); sets *converged_out when estimation
// finished early (the caller stops feeding chunks).
extern "C" int64_t glue_stats_scan(void* v, const uint8_t* data, int64_t len,
                                   int32_t* converged_out) {
  auto* c = (statsN::StatsCtx*)v;
  const int32_t n_refs = (int32_t)c->ref_lens.size();
  int64_t p = 0;
  while (p + 4 <= len) {
    uint32_t sz;
    std::memcpy(&sz, data + p, 4);
    if (p + 4 + (int64_t)sz > len) break;
    const uint8_t* b = data + p + 4;
    p += 4 + sz;
    if (sz < 32) break;  // corrupt/truncated record: the fixed 32-byte
                         // header below would read out of bounds (the
                         // Python path raises struct.error here)
    if (c->converged) continue;  // keep consuming for the carry logic
    int32_t tid, pos, l_seq, mtid, mpos, tlen;
    std::memcpy(&tid, b, 4);
    std::memcpy(&pos, b + 4, 4);
    if (tid < 0 || tid >= n_refs) continue;
    if (pos < c->start_at[tid]) continue;
    if (pos < c->skip_until[tid]) continue;
    int32_t flag = (int32_t)b[14] | ((int32_t)b[15] << 8);
    if (flag & 0x900) continue;
    std::memcpy(&l_seq, b + 16, 4);
    std::memcpy(&mtid, b + 20, 4);
    std::memcpy(&mpos, b + 24, 4);
    std::memcpy(&tlen, b + 28, 4);
    c->total_base += l_seq;
    if (!c->span_set[tid]) {
      c->span_set[tid] = 1;
      c->span_lo[tid] = pos;
    }
    if (pos > c->span_hi[tid]) c->span_hi[tid] = pos;
    // handle_basic
    c->c_total++;
    if (flag & 0x1) {
      c->c_paired++;
      if (b[9] == 0) c->c_lowq++;
    } else {
      c->c_unpaired++;
    }
    // handle_check
    bool is_rp = false;
    if ((flag & 0x1) && !(flag & 0x4) && !(flag & 0x8) && tid == mtid) {
      bool rev = (flag & 0x10) != 0;
      if (rev != ((flag & 0x20) != 0))
        is_rp = rev ? (mpos <= pos) : (pos <= mpos);
    }
    if (is_rp) {
      int32_t fs = statsN::simplified_frag(tlen < 0 ? -(int64_t)tlen : tlen);
      c->buf_rp++;
      if (fs >= statsN::kAbnormalSize) c->buf_abn++;
      c->buf_sizes.push_back(fs);
    }
    if (c->buf_rp >= statsN::kBufferFull) {
      bool normal = ((double)c->buf_abn / (double)c->buf_rp)
                    < statsN::kAbnormalFrac;
      if (normal) c->add_buffered();
      c->clear_buffer();
      if (!normal) {  // BREAK: skip ahead chrom/100
        int64_t step = c->ref_lens[tid] / 100;
        c->skip_until[tid] = pos + (step > 1 ? step : 1);
        continue;
      }
    }
    if (!c->checked) continue;
    c->convergence_test();
  }
  *converged_out = c->converged ? 1 : 0;
  return p;
}

extern "C" void glue_stats_sizes(void* v, int64_t* out) {
  auto* c = (statsN::StatsCtx*)v;
  out[0] = (int64_t)c->frag.counts.size();
  out[1] = (int64_t)c->buf_sizes.size();
}

extern "C" void glue_stats_export(void* v, int32_t* hist_sizes,
                                  int64_t* hist_counts, int32_t* buf_sizes,
                                  int64_t* scalars) {
  auto* c = (statsN::StatsCtx*)v;
  int64_t i = 0;
  for (const auto& kv : c->frag.counts) {
    hist_sizes[i] = kv.first;
    hist_counts[i] = kv.second;
    i++;
  }
  for (size_t k = 0; k < c->buf_sizes.size(); k++)
    buf_sizes[k] = c->buf_sizes[k];
  int64_t span = 0;
  for (size_t t = 0; t < c->span_lo.size(); t++)
    if (c->span_set[t]) span += c->span_hi[t] - c->span_lo[t];
  scalars[0] = c->frag.total;
  scalars[1] = c->c_total;
  scalars[2] = c->c_paired;
  scalars[3] = c->c_unpaired;
  scalars[4] = c->c_lowq;
  scalars[5] = c->c_hc;
  scalars[6] = c->buf_rp;
  scalars[7] = c->buf_abn;
  scalars[8] = c->checked ? 1 : 0;
  scalars[9] = c->converged ? 1 : 0;
  scalars[10] = c->total_base;
  scalars[11] = span;
}

extern "C" void glue_stats_free(void* v) { delete (statsN::StatsCtx*)v; }
