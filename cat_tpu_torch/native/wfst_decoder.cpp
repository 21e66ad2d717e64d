// Native WFST Viterbi beam decoder core (C ABI, loaded via ctypes), the
// port's copy of cat_tpu/native/wfst_decoder.cpp.
//
// The hot loop of TLG decoding, in the role of Kaldi's
// LatticeFasterDecoder: token passing over CSR arc tables with epsilon
// closure, beam + max-active pruning and backpointer traceback
// (wfst_viterbi), and K tokens a state for n-best lists (wfst_nbest).
// The Python WfstDecoder (cat_tpu_torch/fst/decode.py) is its reference.
//
// Built on the host by cat_tpu_torch/native/__init__.py:
//   g++ -O3 -std=c++17 -shared -fPIC wfst_decoder.cpp -o libwfst_decoder.so

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr float kNegInf = -1e30f;

struct Token {
  float score;
  int32_t bp;  // index into the backpointer arena, -1 for none
};

struct BackPtr {
  int32_t prev;    // arena index of predecessor
  int32_t olabel;  // 0 = epsilon
};

struct Csr {
  std::vector<int32_t> offset;  // num_states + 1
  std::vector<int32_t> dst;
  std::vector<int32_t> label;   // am index for emitting arcs
  std::vector<int32_t> olabel;
  std::vector<float> weight;
};

void build_csr(Csr* csr, int num_states, const int32_t* src,
               const int32_t* dst, const int32_t* label,
               const int32_t* olabel, const float* weight, int n) {
  std::vector<int32_t> count(num_states + 1, 0);
  for (int i = 0; i < n; ++i) count[src[i] + 1]++;
  for (int s = 0; s < num_states; ++s) count[s + 1] += count[s];
  csr->offset = count;
  csr->dst.resize(n);
  csr->label.resize(n);
  csr->olabel.resize(n);
  csr->weight.resize(n);
  std::vector<int32_t> pos(count.begin(), count.end() - 1);
  for (int i = 0; i < n; ++i) {
    int p = pos[src[i]]++;
    csr->dst[p] = dst[i];
    csr->label[p] = label ? label[i] : 0;
    csr->olabel[p] = olabel[i];
    csr->weight[p] = weight[i];
  }
}

}  // namespace

extern "C" {

// Returns the number of output words (>= 0), or -1 on error.
int wfst_viterbi(
    // emitting arcs (ilabel > 0; label = ilabel - 1 = AM index)
    const int32_t* e_src, const int32_t* e_dst, const int32_t* e_label,
    const int32_t* e_olabel, const float* e_weight, int32_t n_emit,
    // epsilon (non-emitting) arcs
    const int32_t* n_src, const int32_t* n_dst, const int32_t* n_olabel,
    const float* n_weight, int32_t n_eps,
    int32_t num_states, int32_t start, const float* final_weight,
    // frame log-probs (T x V, row-major)
    const float* logprobs, int32_t T, int32_t V,
    float beam, int32_t max_active, float ac_scale,
    int32_t* out_words, int32_t max_out, float* out_score) {
  if (num_states <= 0 || start < 0 || start >= num_states) return -1;
  Csr emit, eps;
  build_csr(&emit, num_states, e_src, e_dst, e_label, e_olabel, e_weight,
            n_emit);
  build_csr(&eps, num_states, n_src, n_dst, nullptr, n_olabel, n_weight,
            n_eps);

  std::vector<Token> cur(num_states, {kNegInf, -1});
  std::vector<Token> nxt(num_states, {kNegInf, -1});
  std::vector<int32_t> active;
  std::vector<int32_t> next_active;
  std::vector<BackPtr> arena;
  arena.reserve(1 << 16);

  cur[start] = {0.0f, -1};
  active.push_back(start);

  auto eps_expand = [&](std::vector<Token>& toks,
                        std::vector<int32_t>& act) {
    // relax non-emitting arcs to fixed point (bounded passes)
    for (int pass = 0; pass < 20; ++pass) {
      bool changed = false;
      size_t cnt = act.size();
      for (size_t i = 0; i < cnt; ++i) {
        int s = act[i];
        float sc = toks[s].score;
        if (sc <= kNegInf / 2) continue;
        for (int a = eps.offset[s]; a < eps.offset[s + 1]; ++a) {
          float ns = sc + eps.weight[a];
          int d = eps.dst[a];
          if (ns > toks[d].score) {
            bool was_dead = toks[d].score <= kNegInf / 2;
            arena.push_back({toks[s].bp, eps.olabel[a]});
            toks[d] = {ns, (int32_t)(arena.size() - 1)};
            if (was_dead) act.push_back(d);
            changed = true;
          }
        }
      }
      if (!changed) break;
    }
  };

  eps_expand(cur, active);

  std::vector<float> scores_buf;
  for (int t = 0; t < T; ++t) {
    const float* row = logprobs + (size_t)t * V;
    for (int s : next_active) nxt[s] = {kNegInf, -1};
    next_active.clear();
    for (int s : active) {
      float sc = cur[s].score;
      if (sc <= kNegInf / 2) continue;
      for (int a = emit.offset[s]; a < emit.offset[s + 1]; ++a) {
        int lab = emit.label[a];
        if (lab < 0 || lab >= V) continue;
        float ns = sc + emit.weight[a] + ac_scale * row[lab];
        int d = emit.dst[a];
        if (ns > nxt[d].score) {
          bool was_dead = nxt[d].score <= kNegInf / 2;
          arena.push_back({cur[s].bp, emit.olabel[a]});
          nxt[d] = {ns, (int32_t)(arena.size() - 1)};
          if (was_dead) next_active.push_back(d);
        }
      }
    }
    eps_expand(nxt, next_active);
    // prune: beam + max_active
    float best = kNegInf;
    for (int s : next_active) best = std::max(best, nxt[s].score);
    float thresh = best - beam;
    if ((int)next_active.size() > max_active) {
      scores_buf.clear();
      for (int s : next_active) scores_buf.push_back(nxt[s].score);
      std::nth_element(scores_buf.begin(),
                       scores_buf.end() - max_active, scores_buf.end());
      thresh = std::max(thresh, scores_buf[scores_buf.size() -
                                           max_active]);
    }
    size_t w = 0;
    for (int s : next_active) {
      if (nxt[s].score >= thresh) {
        next_active[w++] = s;
      } else {
        nxt[s] = {kNegInf, -1};
      }
    }
    next_active.resize(w);
    // clear old actives and swap
    for (int s : active) cur[s] = {kNegInf, -1};
    cur.swap(nxt);
    active.swap(next_active);
    if (active.empty()) return -1;
  }

  // final state selection
  float best = kNegInf;
  int32_t best_bp = -1;
  bool any_final = false;
  for (int s : active) {
    if (final_weight[s] > kNegInf / 2) {
      any_final = true;
      float sc = cur[s].score + final_weight[s];
      if (sc > best) {
        best = sc;
        best_bp = cur[s].bp;
      }
    }
  }
  if (!any_final) {
    for (int s : active) {
      if (cur[s].score > best) {
        best = cur[s].score;
        best_bp = cur[s].bp;
      }
    }
  }
  *out_score = best;
  // traceback
  std::vector<int32_t> words;
  for (int32_t bp = best_bp; bp >= 0; bp = arena[bp].prev) {
    if (arena[bp].olabel != 0) words.push_back(arena[bp].olabel);
  }
  int n_words = std::min<int32_t>((int32_t)words.size(), max_out);
  for (int i = 0; i < n_words; ++i) {
    out_words[i] = words[words.size() - 1 - i];
  }
  return n_words;
}

// N-best token passing: each state carries up to K tokens
// (score + backpointer); at the end the top tokens at final states are
// traced back and deduplicated by word sequence: K-token Viterbi in the
// role of a lattice's n-best list for rescoring, instead of a
// determinized lattice.
int wfst_nbest(
    const int32_t* e_src, const int32_t* e_dst, const int32_t* e_label,
    const int32_t* e_olabel, const float* e_weight, int32_t n_emit,
    const int32_t* n_src, const int32_t* n_dst, const int32_t* n_olabel,
    const float* n_weight, int32_t n_eps,
    int32_t num_states, int32_t start, const float* final_weight,
    const float* logprobs, int32_t T, int32_t V,
    float beam, int32_t max_active, float ac_scale, int32_t K,
    int32_t* out_words /* K x max_out */, int32_t* out_lens /* K */,
    float* out_scores /* K */, int32_t max_out) {
  if (num_states <= 0 || start < 0 || start >= num_states || K <= 0)
    return -1;
  Csr emit, eps;
  build_csr(&emit, num_states, e_src, e_dst, e_label, e_olabel, e_weight,
            n_emit);
  build_csr(&eps, num_states, n_src, n_dst, nullptr, n_olabel, n_weight,
            n_eps);

  // per-state token lists, kept sorted by descending score
  struct TokL {
    std::vector<Token> toks;
  };
  std::vector<TokL> cur(num_states), nxt(num_states);
  std::vector<int32_t> active, next_active;
  std::vector<BackPtr> arena;
  arena.reserve(1 << 16);

  auto insert_tok = [K](TokL& tl, float score, int32_t bp) -> bool {
    auto& v = tl.toks;
    if ((int)v.size() >= K && score <= v.back().score) return false;
    for (auto& t : v)
      if (t.bp == bp) {  // identical history: keep the better score
        if (score <= t.score) return false;
        t.score = score;
        std::sort(v.begin(), v.end(),
                  [](const Token& a, const Token& b) {
                    return a.score > b.score;
                  });
        return true;
      }
    Token t{score, bp};
    auto it = std::lower_bound(
        v.begin(), v.end(), t, [](const Token& a, const Token& b) {
          return a.score > b.score;
        });
    v.insert(it, t);
    if ((int)v.size() > K) v.pop_back();
    return true;
  };

  cur[start].toks.push_back({0.0f, -1});
  active.push_back(start);

  auto eps_expand = [&](std::vector<TokL>& toks,
                        std::vector<int32_t>& act) {
    for (int pass = 0; pass < 20; ++pass) {
      bool changed = false;
      size_t cnt = act.size();
      for (size_t i = 0; i < cnt; ++i) {
        int s = act[i];
        for (int a = eps.offset[s]; a < eps.offset[s + 1]; ++a) {
          int d = eps.dst[a];
          bool was_dead = toks[d].toks.empty();
          // snapshot size: tokens added to s in this pass expand next
          size_t ns_tok = toks[s].toks.size();
          for (size_t k = 0; k < ns_tok; ++k) {
            float sc = toks[s].toks[k].score + eps.weight[a];
            arena.push_back({toks[s].toks[k].bp, eps.olabel[a]});
            int32_t bp = (int32_t)(arena.size() - 1);
            if (insert_tok(toks[d], sc, bp)) {
              changed = true;
            } else {
              arena.pop_back();
            }
          }
          if (was_dead && !toks[d].toks.empty()) act.push_back(d);
        }
      }
      if (!changed) break;
    }
  };

  eps_expand(cur, active);

  std::vector<float> scores_buf;
  for (int t = 0; t < T; ++t) {
    const float* row = logprobs + (size_t)t * V;
    for (int s : next_active) nxt[s].toks.clear();
    next_active.clear();
    for (int s : active) {
      if (cur[s].toks.empty()) continue;
      for (int a = emit.offset[s]; a < emit.offset[s + 1]; ++a) {
        int lab = emit.label[a];
        if (lab < 0 || lab >= V) continue;
        int d = emit.dst[a];
        bool was_dead = nxt[d].toks.empty();
        for (const Token& tok : cur[s].toks) {
          float ns = tok.score + emit.weight[a] + ac_scale * row[lab];
          arena.push_back({tok.bp, emit.olabel[a]});
          int32_t bp = (int32_t)(arena.size() - 1);
          if (!insert_tok(nxt[d], ns, bp)) arena.pop_back();
        }
        if (was_dead && !nxt[d].toks.empty()) next_active.push_back(d);
      }
    }
    eps_expand(nxt, next_active);
    float best = kNegInf;
    for (int s : next_active)
      if (!nxt[s].toks.empty())
        best = std::max(best, nxt[s].toks[0].score);
    float thresh = best - beam;
    if ((int)next_active.size() > max_active) {
      scores_buf.clear();
      for (int s : next_active)
        scores_buf.push_back(nxt[s].toks.empty() ? kNegInf
                                                 : nxt[s].toks[0].score);
      std::nth_element(scores_buf.begin(),
                       scores_buf.end() - max_active, scores_buf.end());
      thresh = std::max(thresh,
                        scores_buf[scores_buf.size() - max_active]);
    }
    size_t w = 0;
    for (int s : next_active) {
      if (!nxt[s].toks.empty() && nxt[s].toks[0].score >= thresh) {
        next_active[w++] = s;
      } else {
        nxt[s].toks.clear();
      }
    }
    next_active.resize(w);
    for (int s : active) cur[s].toks.clear();
    cur.swap(nxt);
    active.swap(next_active);
    if (active.empty()) return -1;
  }

  // collect final tokens (score + final weight; fall back to all
  // actives when no reachable final state)
  std::vector<Token> finals;
  bool any_final = false;
  for (int s : active)
    if (final_weight[s] > kNegInf / 2) any_final = true;
  for (int s : active) {
    float fw = any_final ? final_weight[s] : 0.0f;
    if (any_final && final_weight[s] <= kNegInf / 2) continue;
    for (const Token& tok : cur[s].toks)
      finals.push_back({tok.score + fw, tok.bp});
  }
  std::sort(finals.begin(), finals.end(),
            [](const Token& a, const Token& b) {
              return a.score > b.score;
            });

  // traceback + dedup by word sequence
  std::vector<std::vector<int32_t>> seen;
  int n_out = 0;
  for (const Token& tok : finals) {
    if (n_out >= K) break;
    std::vector<int32_t> words;
    for (int32_t bp = tok.bp; bp >= 0; bp = arena[bp].prev)
      if (arena[bp].olabel != 0) words.push_back(arena[bp].olabel);
    std::reverse(words.begin(), words.end());
    bool dup = false;
    for (const auto& w : seen)
      if (w == words) {
        dup = true;
        break;
      }
    if (dup) continue;
    seen.push_back(words);
    int n_words = std::min<int32_t>((int32_t)words.size(), max_out);
    for (int i = 0; i < n_words; ++i)
      out_words[(size_t)n_out * max_out + i] = words[i];
    out_lens[n_out] = n_words;
    out_scores[n_out] = tok.score;
    ++n_out;
  }
  return n_out;
}

}  // extern "C"
