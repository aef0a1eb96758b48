// scd_tpu native min-cost-flow solver.
//
// The reference delegates its size-constrained k-means E-step to OR-Tools'
// C++ SimpleMinCostFlow through a Cython shim (reference
// local_utils/k_means_constrained/mincostflow_vectorized_.pyx and
// sskm_constrained.py:331-356).  This is an independent implementation of
// the same problem class, written for this framework:
//
//  - cost-scaling push-relabel (Goldberg-Tarjan), the same algorithm family
//    OR-Tools uses, for large instances;
//  - successive-shortest-paths with Dijkstra potentials as a second,
//    simpler solver used to cross-validate on small instances.
//
// Exposed as a plain C ABI for ctypes (no pybind11 in this image):
//
//   scd_mcf_solve(...)            -- generic MCF over an arc list
//   scd_constrained_assign(...)   -- builds the k-means size-constraint
//                                    graph internally and returns labels
//
// Graph for constrained assignment (same formulation as the reference,
// sskm_constrained.py:277-328): X-nodes supply 1 each; per cluster a dummy
// C' receives arcs from every X with the (rounded) distance cost; C' -> C
// with capacity size_max; C -> artificial sink with capacity n_X; C demands
// size_min, the artificial node absorbs the remainder.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <limits>
#include <queue>
#include <vector>

namespace {

using i64 = long long;

struct Graph {
  int n = 0;
  std::vector<int> first;      // per node: first arc index (-1 none)
  std::vector<int> next_arc;   // per arc: next arc of same tail
  std::vector<int> to;         // per arc: head node
  std::vector<i64> cap;        // per arc: residual capacity
  std::vector<i64> cost;       // per arc: cost (negated on reverse arc)

  explicit Graph(int n_nodes) : n(n_nodes), first(n_nodes, -1) {}

  void reserve(size_t m) {
    next_arc.reserve(2 * m);
    to.reserve(2 * m);
    cap.reserve(2 * m);
    cost.reserve(2 * m);
  }

  int add_edge(int u, int v, i64 c, i64 w) {
    int a = static_cast<int>(to.size());
    to.push_back(v); cap.push_back(c); cost.push_back(w);
    next_arc.push_back(first[u]); first[u] = a;
    to.push_back(u); cap.push_back(0); cost.push_back(-w);
    next_arc.push_back(first[v]); first[v] = a + 1;
    return a;
  }

  int tail_of(int a) const { return to[a ^ 1]; }
};

// ---------------------------------------------------------------- cost scaling

class CostScaling {
 public:
  // ``bounded_relabels``: enable the heuristic per-node relabel cap that
  // aborts as "infeasible" (used for the sparse candidate subgraphs, which
  // CAN be infeasible and would otherwise churn to the generic guard).
  // The terminal dense solve runs UNBOUNDED except for the guard — its
  // instances are feasible by the caller's pre-check, and a heuristic cap
  // would turn an adversarial-but-feasible solve into a crash.
  CostScaling(Graph& g, std::vector<i64> supply, bool bounded_relabels = false)
      : g_(g), excess_(std::move(supply)), price_(g.n, 0), cur_(g.n, -1),
        bounded_relabels_(bounded_relabels) {}

  // Node prices after solve(): in SCALED cost units (costs were multiplied
  // in place by n+1).  The final refine ran at eps=1, so every residual
  // arc satisfies scaled_reduced_cost >= -1 — the certificate the sparse
  // pricing loop checks for arcs it left out of the graph.
  const std::vector<i64>& prices() const { return price_; }

  // Returns true on success (all excesses settled at eps-optimality -> optimal
  // after the final eps < 1 round with integer costs).
  bool solve() {
    const i64 scale = static_cast<i64>(g_.n) + 1;
    i64 max_cost = 0;
    for (size_t a = 0; a < g_.cost.size(); a += 2) {
      g_.cost[a] *= scale;
      g_.cost[a + 1] *= scale;
      max_cost = std::max(max_cost, std::llabs(g_.cost[a]));
    }
    i64 eps = std::max<i64>(max_cost, 1);
    const i64 alpha = 16;
    while (true) {
      eps = std::max<i64>(1, eps / alpha);
      if (!refine(eps)) return false;
      if (eps == 1) break;
    }
    return true;
  }

 private:
  i64 reduced(int a, int u) const {
    return g_.cost[a] + price_[u] - price_[g_.to[a]];
  }

  // Global price update (set-relabel, the CS2 heuristic): bucketed
  // Dijkstra from the deficit nodes over residual arcs, edge weight =
  // number of eps-steps needed to make the arc admissible
  // (0 if already negative reduced cost, floor(rc/eps)+1 otherwise);
  // then price[u] -= rank[u]*eps.  Preserves eps-optimality: for any
  // residual arc (u,v), rank[u] <= rank[v] + w(u,v) by relaxation, so the
  // repriced reduced cost stays >= -eps.  Nodes further than R_CAP ranks
  // (and unreachable ones) all drop by exactly R_CAP*eps — a uniform
  // shift that keeps their relative reduced costs intact.  This is what
  // keeps the discharge loop from churning on long admissible-path
  // droughts (the classic ~10x cost-scaling accelerator).
  void global_update(i64 eps) {
    // Rank cap: the textbook set-relabel bound is O(n) ranks per refine
    // (path reduced costs are >= -2*eps*len coming out of the previous
    // eps round); nodes beyond the cap shift uniformly, which is safe.
    const int R_CAP = 3 * g_.n + 3;
    // rank_/buckets_ are members reused across calls (a global update runs
    // every max(n/2,256) relabels plus once per refine; reallocating the
    // O(3n) vector-of-vectors each call cost ~200k vector constructions at
    // N=65k).  The sweep below clears buckets_[0..R_CAP-1] as it goes;
    // only the overflow bucket needs an explicit clear on re-entry.
    if (rank_.size() != static_cast<size_t>(g_.n)) {
      rank_.assign(g_.n, R_CAP);
      buckets_.resize(R_CAP + 1);
    } else {
      std::fill(rank_.begin(), rank_.end(), R_CAP);
      buckets_[R_CAP].clear();
    }
    std::vector<int>& rank = rank_;
    std::vector<std::vector<int>>& buckets = buckets_;
    for (int u = 0; u < g_.n; ++u) {
      if (excess_[u] < 0) { rank[u] = 0; buckets[0].push_back(u); }
    }
    for (int r = 0; r < R_CAP; ++r) {
      for (size_t qi = 0; qi < buckets[r].size(); ++qi) {
        int v = buckets[r][qi];
        if (rank[v] != r) continue;  // stale entry
        // in-arcs of v are the pairs of v's adjacency: a=(v,u) pairs a^1=(u,v)
        for (int a = g_.first[v]; a != -1; a = g_.next_arc[a]) {
          int u = g_.to[a];
          int ra = a ^ 1;  // u -> v
          if (g_.cap[ra] <= 0) continue;
          i64 rc = g_.cost[ra] + price_[u] - price_[v];
          int w = rc < 0 ? 0 : static_cast<int>(std::min<i64>(
                                   rc / eps + 1, R_CAP));
          int nr = std::min(r + w, R_CAP);
          if (nr < rank[u]) {
            rank[u] = nr;
            if (nr <= R_CAP) buckets[nr].push_back(u);
          }
        }
      }
      buckets[r].clear();
    }
    // Price floor: nodes unreachable from the deficits drop by R_CAP*eps
    // every update; with adversarial near-2^31 costs at N=65k the scaled
    // eps is ~1e13 and repeated updates could in principle underflow i64.
    // Detect it and fail the refine (solver returns false -> caller raises)
    // instead of silently wrapping.
    const i64 price_floor = std::numeric_limits<i64>::min() / 4;
    for (int u = 0; u < g_.n; ++u) {
      if (rank[u] > 0) {
        price_[u] -= static_cast<i64>(rank[u]) * eps;
        if (price_[u] < price_floor) price_underflow_ = true;
        cur_[u] = g_.first[u];
      }
    }
  }

  bool refine(i64 eps) {
    // Saturate every negative-reduced-cost residual arc.
    for (int u = 0; u < g_.n; ++u) {
      for (int a = g_.first[u]; a != -1; a = g_.next_arc[a]) {
        if (g_.cap[a] > 0 && reduced(a, u) < 0) {
          i64 d = g_.cap[a];
          excess_[u] -= d;
          excess_[g_.to[a]] += d;
          g_.cap[a] -= d;
          g_.cap[a ^ 1] += d;
        }
      }
      cur_[u] = g_.first[u];
    }
    global_update(eps);
    if (price_underflow_) return false;
    std::queue<int> active;
    std::vector<char> in_queue(g_.n, 0);
    for (int u = 0; u < g_.n; ++u) {
      if (excess_[u] > 0) { active.push(u); in_queue[u] = 1; }
    }
    // Discharge loop. The relabel count bound gives termination; we add a
    // generous safety counter so a logic bug cannot hang the host process.
    long long guard = 0;
    const long long guard_max =
        40LL * static_cast<long long>(g_.n) * static_cast<long long>(g_.n) +
        static_cast<long long>(g_.cost.size()) * 64LL;
    long long relabels = 0;
    const long long relabel_trigger = std::max(g_.n / 2, 256);
    // Feasibility cut-off: per refine, a feasible graph bounds each
    // node's price decrease by ~(1+alpha)*n*eps (the Goldberg-Tarjan 3n
    // lemma is for eps-halving; this solver scales by alpha=16), i.e.
    // <= ~17n relabels per node.  An INFEASIBLE graph (possible for the
    // sparse candidate subgraph) has excess nodes that relabel forever —
    // without this bound they churn until the generic guard, minutes
    // instead of milliseconds.  Cap at 24n for slack above the bound.
    std::vector<int> n_relabel(g_.n, 0);
    const long long relabel_cap =
        bounded_relabels_ ? 24LL * g_.n + 16 : (1LL << 62);
    while (!active.empty()) {
      int u = active.front(); active.pop(); in_queue[u] = 0;
      while (excess_[u] > 0) {
        if (++guard > guard_max) return false;
        int a = cur_[u];
        if (a == -1) {  // relabel
          i64 best = std::numeric_limits<i64>::min();
          for (int b = g_.first[u]; b != -1; b = g_.next_arc[b]) {
            if (g_.cap[b] > 0) {
              best = std::max(best, price_[g_.to[b]] - g_.cost[b]);
            }
          }
          if (best == std::numeric_limits<i64>::min()) return false;  // stuck
          if (++n_relabel[u] > relabel_cap) return false;  // infeasible
          price_[u] = best - eps;
          cur_[u] = g_.first[u];
          if (++relabels >= relabel_trigger) {
            relabels = 0;
            global_update(eps);
            if (price_underflow_) return false;
            // repricing may have made u's earlier arcs admissible again
            cur_[u] = g_.first[u];
          }
          continue;
        }
        if (g_.cap[a] > 0 && reduced(a, u) < 0) {  // push
          int v = g_.to[a];
          i64 d = std::min(excess_[u], g_.cap[a]);
          g_.cap[a] -= d;
          g_.cap[a ^ 1] += d;
          excess_[u] -= d;
          excess_[v] += d;
          if (excess_[v] > 0 && !in_queue[v]) { active.push(v); in_queue[v] = 1; }
        } else {
          cur_[u] = g_.next_arc[a];
        }
      }
    }
    for (int u = 0; u < g_.n; ++u) {
      if (excess_[u] != 0) return false;  // infeasible
    }
    return true;
  }

  Graph& g_;
  std::vector<i64> excess_;
  std::vector<i64> price_;
  std::vector<int> cur_;
  bool bounded_relabels_ = false;
  bool price_underflow_ = false;
  std::vector<int> rank_;                 // global_update scratch, reused
  std::vector<std::vector<int>> buckets_;  // across calls (see global_update)
};

// ------------------------------------------------- successive shortest paths

class SSP {
 public:
  SSP(Graph& g, std::vector<i64> supply)
      : g_(g), excess_(std::move(supply)), pot_(g.n, 0) {}

  bool solve() {
    std::vector<int> sources, sinks;
    for (int u = 0; u < g_.n; ++u) {
      if (excess_[u] > 0) sources.push_back(u);
    }
    for (int s : sources) {
      while (excess_[s] > 0) {
        if (!augment(s)) return false;
      }
    }
    return true;
  }

 private:
  bool augment(int s) {
    const i64 INF = std::numeric_limits<i64>::max();
    std::vector<i64> dist(g_.n, INF);
    std::vector<int> parent_arc(g_.n, -1);
    using QE = std::pair<i64, int>;
    std::priority_queue<QE, std::vector<QE>, std::greater<QE>> pq;
    dist[s] = 0;
    pq.push({0, s});
    while (!pq.empty()) {
      auto [d, u] = pq.top(); pq.pop();
      if (d > dist[u]) continue;
      for (int a = g_.first[u]; a != -1; a = g_.next_arc[a]) {
        if (g_.cap[a] <= 0) continue;
        int v = g_.to[a];
        i64 nd = d + g_.cost[a] + pot_[u] - pot_[v];
        if (nd < dist[v]) {
          dist[v] = nd;
          parent_arc[v] = a;
          pq.push({nd, v});
        }
      }
    }
    // nearest reachable node with negative excess
    int t = -1;
    i64 best = INF;
    for (int u = 0; u < g_.n; ++u) {
      if (excess_[u] < 0 && dist[u] < best) { best = dist[u]; t = u; }
    }
    if (t == -1) return false;
    for (int u = 0; u < g_.n; ++u) {
      if (dist[u] < INF) pot_[u] += dist[u];
    }
    i64 push = std::min(excess_[s], -excess_[t]);
    for (int v = t; v != s;) {
      int a = parent_arc[v];
      push = std::min(push, g_.cap[a]);
      v = g_.tail_of(a);
    }
    for (int v = t; v != s;) {
      int a = parent_arc[v];
      g_.cap[a] -= push;
      g_.cap[a ^ 1] += push;
      v = g_.tail_of(a);
    }
    excess_[s] -= push;
    excess_[t] += push;
    return true;
  }

  Graph& g_;
  std::vector<i64> excess_;
  std::vector<i64> pot_;
};

// --------------------------------------- sparse candidate-arc pricing
//
// The constrained E-step is a transportation problem with unit supplies:
// nearly every point ends up at one of its few nearest clusters, so the
// dense n_x * n_c arc list is ~95% dead weight.  Column generation makes
// the sparse shortcut EXACT:
//   1. solve on each point's M cheapest clusters (plus, per cluster, its
//      cheapest points so size_min stays reachable);
//   2. the solver's node prices certify eps-optimality (eps=1 in scaled
//      units) for every arc IN the graph; scan the excluded arcs for
//      scaled reduced cost < 0 and add any violators;
//   3. repeat until no violations — the flow is then eps-optimal over the
//      FULL graph, which at eps < 1/n (scale = n+1) is optimal, the same
//      certificate the dense solve gives.
// Falls back to the dense graph if pricing fails to converge or the
// candidate graph is infeasible at maximum density.

struct SparseResult {
  bool ok = false;
  std::vector<int> labels;
};

// Feasibility check for a candidate set: can every point be assigned while
// each cluster holds size_min..size_max?  A unit-capacity bipartite
// max-flow (Dinic, O(E*sqrt(V)) on unit networks) answers in well under a
// second, where letting the cost solver discover infeasibility by price
// churn takes minutes.  Graph: s -> X (1 each), X -> candidate clusters
// (1), cluster j -> t (size_max); the size_min side is covered by a second
// pass with capacities size_min and demand n_c*size_min.
class Dinic {
 public:
  explicit Dinic(int n) : n_(n), first_(n, -1) {}

  void add(int u, int v, int c) {
    to_.push_back(v); cap_.push_back(c); next_.push_back(first_[u]);
    first_[u] = static_cast<int>(to_.size()) - 1;
    to_.push_back(u); cap_.push_back(0); next_.push_back(first_[v]);
    first_[v] = static_cast<int>(to_.size()) - 1;
  }

  i64 maxflow(int s, int t) {
    i64 total = 0;
    while (bfs(s, t)) {
      cur_ = first_;
      i64 f;
      while ((f = dfs(s, t, std::numeric_limits<i64>::max())) > 0) total += f;
    }
    return total;
  }

 private:
  bool bfs(int s, int t) {
    level_.assign(n_, -1);
    std::queue<int> q;
    level_[s] = 0; q.push(s);
    while (!q.empty()) {
      int u = q.front(); q.pop();
      for (int a = first_[u]; a != -1; a = next_[a]) {
        if (cap_[a] > 0 && level_[to_[a]] < 0) {
          level_[to_[a]] = level_[u] + 1;
          q.push(to_[a]);
        }
      }
    }
    return level_[t] >= 0;
  }

  i64 dfs(int u, int t, i64 f) {
    if (u == t) return f;
    for (int& a = cur_[u]; a != -1; a = next_[a]) {
      int v = to_[a];
      if (cap_[a] > 0 && level_[v] == level_[u] + 1) {
        i64 d = dfs(v, t, std::min<i64>(f, cap_[a]));
        if (d > 0) {
          cap_[a] -= d;
          cap_[a ^ 1] += d;
          return d;
        }
      }
    }
    return 0;
  }

  int n_;
  std::vector<int> first_, next_, to_, level_, cur_;
  std::vector<i64> cap_;
};

static bool candidate_set_feasible(int n_x, int n_c, int32_t size_min,
                                   int32_t size_max,
                                   const std::vector<std::vector<int>>& cand) {
  // Exact via the standard lower-bound circulation reduction: the flow
  // network s -> x_i (lb 1, ub 1) -> c_j (ub 1) -> t (lb size_min,
  // ub size_max) -> s (inf) has a feasible circulation iff the derived
  // max-flow S* -> T* saturates all lower-bound demand n_x + n_c*size_min.
  const i64 L = static_cast<i64>(n_c) * size_min;
  const int s = n_x + n_c, t = s + 1, S = t + 1, T = S + 1;
  const int INF = std::numeric_limits<int>::max() / 2;
  Dinic d(T + 1);
  for (int i = 0; i < n_x; ++i) {
    d.add(S, i, 1);  // lb of s -> x_i
    for (int j : cand[i]) d.add(i, n_x + j, 1);
  }
  for (int j = 0; j < n_c; ++j) {
    d.add(n_x + j, t, size_max - size_min);
    if (size_min > 0) d.add(n_x + j, T, size_min);  // lb of c_j -> t
  }
  if (L > 0) d.add(S, t, static_cast<int>(std::min<i64>(L, INF)));
  d.add(t, s, INF);
  d.add(s, T, n_x);
  return d.maxflow(S, T) == static_cast<i64>(n_x) + L;
}

static bool solve_candidate_graph(
    int n_x, int n_c, const int32_t* costs, int32_t size_min,
    int32_t size_max, const std::vector<std::vector<int>>& cand,
    std::vector<i64>* prices_out, std::vector<int>* labels_out) {
  const int cd0 = n_x;
  const int c0 = n_x + n_c;
  const int art = n_x + 2 * n_c;
  Graph g(art + 1);
  size_t m = 0;
  for (const auto& v : cand) m += v.size();
  g.reserve(m + 2 * n_c);
  std::vector<std::vector<int>> arc_of(n_x);
  for (int i = 0; i < n_x; ++i) {
    arc_of[i].reserve(cand[i].size());
    for (int j : cand[i]) {
      arc_of[i].push_back(
          g.add_edge(i, cd0 + j, 1, costs[static_cast<i64>(i) * n_c + j]));
    }
  }
  for (int j = 0; j < n_c; ++j) g.add_edge(cd0 + j, c0 + j, size_max, 0);
  for (int j = 0; j < n_c; ++j) g.add_edge(c0 + j, art, n_x, 0);

  std::vector<i64> sup(art + 1, 0);
  for (int i = 0; i < n_x; ++i) sup[i] = 1;
  for (int j = 0; j < n_c; ++j) sup[c0 + j] = -static_cast<i64>(size_min);
  sup[art] = -(static_cast<i64>(n_x) - static_cast<i64>(n_c) * size_min);

  CostScaling cs(g, std::move(sup), /*bounded_relabels=*/true);
  if (!cs.solve()) return false;

  labels_out->assign(n_x, -1);
  for (int i = 0; i < n_x; ++i) {
    for (size_t s = 0; s < cand[i].size(); ++s) {
      if (g.cap[arc_of[i][s] ^ 1] > 0) {
        (*labels_out)[i] = cand[i][s];
        break;
      }
    }
    if ((*labels_out)[i] < 0) return false;
  }
  *prices_out = cs.prices();
  return true;
}

static SparseResult constrained_assign_sparse(int n_x, int n_c,
                                              const int32_t* costs,
                                              int32_t size_min,
                                              int32_t size_max,
                                              bool bail_when_dense) {
  SparseResult res;
  // Row candidates: each point's m0 cheapest clusters.
  int m0 = std::min(n_c, 16);
  std::vector<std::vector<int>> cand(n_x);
  std::vector<int> idx(n_c);
  auto build_rows = [&](int m) {
    for (int i = 0; i < n_x; ++i) {
      const int32_t* row = costs + static_cast<i64>(i) * n_c;
      for (int j = 0; j < n_c; ++j) idx[j] = j;
      if (m < n_c) {
        std::nth_element(idx.begin(), idx.begin() + m, idx.end(),
                         [&](int a, int b) { return row[a] < row[b]; });
      }
      cand[i].assign(idx.begin(), idx.begin() + std::min(m, n_c));
    }
  };
  // Column candidates: each cluster's cheapest size_min points, so the
  // lower bound stays reachable inside the candidate graph.
  auto add_cols = [&]() {
    if (size_min <= 0) return;
    std::vector<int> pts(n_x);
    for (int j = 0; j < n_c; ++j) {
      for (int i = 0; i < n_x; ++i) pts[i] = i;
      int take = std::min(n_x, static_cast<int>(size_min));
      std::nth_element(pts.begin(), pts.begin() + take, pts.end(),
                       [&](int a, int b) {
                         return costs[static_cast<i64>(a) * n_c + j] <
                                costs[static_cast<i64>(b) * n_c + j];
                       });
      for (int t = 0; t < take; ++t) {
        int i = pts[t];
        bool present = false;
        for (int jj : cand[i]) {
          if (jj == j) { present = true; break; }
        }
        if (!present) cand[i].push_back(j);
      }
    }
  };
  build_rows(m0);
  add_cols();

  const i64 scale = static_cast<i64>(n_x) + 2 * n_c + 2;  // g.n + 1
  std::vector<i64> prices;
  std::vector<int> labels;
  std::vector<char> in_cand(n_c, 0);
  for (int round = 0; round < 6; ++round) {
    // Cheap max-flow feasibility gate first: letting the cost solver
    // discover an infeasible candidate set by price churn takes minutes;
    // Dinic answers in well under a second at these sizes.
    while (!candidate_set_feasible(n_x, n_c, size_min, size_max, cand)) {
      if (m0 >= n_c) return res;
      m0 = std::min(n_c, m0 * 2);
      if (bail_when_dense && m0 > n_c / 2) return res;  // no longer sparse:
      // correlated preferences forced near-dense candidates — the dense
      // solve is faster than pricing rounds over a near-dense graph
      build_rows(m0);
      add_cols();
    }
    if (!solve_candidate_graph(n_x, n_c, costs, size_min, size_max, cand,
                               &prices, &labels)) {
      // solver stuck despite feasibility: densify rows
      if (m0 >= n_c) return res;  // give dense fallback a chance
      m0 = std::min(n_c, m0 * 2);
      build_rows(m0);
      add_cols();
      continue;
    }
    // Pricing: any excluded arc with negative scaled reduced cost breaks
    // the optimality certificate; add it and re-solve.
    i64 n_viol = 0;
    for (int i = 0; i < n_x; ++i) {
      for (int j : cand[i]) in_cand[j] = 1;
      const int32_t* row = costs + static_cast<i64>(i) * n_c;
      const i64 pi = prices[i];
      for (int j = 0; j < n_c; ++j) {
        if (in_cand[j]) continue;
        if (static_cast<i64>(row[j]) * scale + pi - prices[n_x + j] < 0) {
          cand[i].push_back(j);
          ++n_viol;
        }
      }
      for (int j = 0; j < n_c; ++j) in_cand[j] = 0;
    }
    if (n_viol == 0) {
      res.ok = true;
      res.labels = std::move(labels);
      return res;
    }
  }
  return res;  // pricing did not converge -> dense fallback
}

}  // namespace

extern "C" {

// Generic MCF over an explicit arc list. out_flow receives per-arc flow.
// method: 0 = auto (cost-scaling), 1 = SSP, 2 = cost-scaling.
// Returns 0 on optimal, 1 on infeasible/failure.
int scd_mcf_solve(int32_t n_nodes, int64_t n_arcs, const int32_t* tail,
                  const int32_t* head, const int32_t* cap,
                  const int32_t* cost, const int32_t* supply,
                  int64_t* out_flow, int32_t method) {
  Graph g(n_nodes);
  g.reserve(static_cast<size_t>(n_arcs));
  std::vector<int> arc_ids(n_arcs);
  for (int64_t i = 0; i < n_arcs; ++i) {
    arc_ids[i] = g.add_edge(tail[i], head[i], cap[i], cost[i]);
  }
  std::vector<i64> sup(n_nodes);
  for (int i = 0; i < n_nodes; ++i) sup[i] = supply[i];

  bool ok;
  if (method == 1) {
    ok = SSP(g, std::move(sup)).solve();
  } else {
    ok = CostScaling(g, std::move(sup)).solve();
  }
  if (!ok) return 1;
  for (int64_t i = 0; i < n_arcs; ++i) {
    out_flow[i] = g.cap[arc_ids[i] ^ 1];  // reverse residual == flow
  }
  return 0;
}

// Size-constrained nearest-centroid assignment (the ConSSKM E-step).
// costs: row-major [n_x, n_c] int32 (pre-rounded, reference rounds
// 1000*sqrt(dist)); out_labels: [n_x] int32.
// method: 1 = SSP, 2 = dense cost-scaling, 3 = force sparse pricing,
// 0/other = auto (sparse pricing for large instances, dense fallback).
int scd_constrained_assign(int32_t n_x, int32_t n_c, const int32_t* costs,
                           int32_t size_min, int32_t size_max,
                           int32_t* out_labels, int32_t method) {
  if (static_cast<i64>(size_min) * n_c > n_x) return 2;       // infeasible
  if (static_cast<i64>(size_max) * n_c < n_x) return 2;       // infeasible

  // Row normalization: every point is assigned exactly once, so
  // subtracting row i's minimum shifts the objective by a constant and
  // leaves the optimal assignment unchanged — while collapsing the cost
  // RANGE cost-scaling has to sweep.  Distance matrices where all
  // clusters are far (early Lloyd iterations, outlier points) otherwise
  // force many eps rounds over huge magnitudes for tiny discriminating
  // differences.
  std::vector<int32_t> norm(static_cast<size_t>(n_x) * n_c);
  for (int i = 0; i < n_x; ++i) {
    const int32_t* row = costs + static_cast<i64>(i) * n_c;
    int32_t mn = row[0];
    for (int j = 1; j < n_c; ++j) mn = std::min(mn, row[j]);
    int32_t* out = norm.data() + static_cast<i64>(i) * n_c;
    for (int j = 0; j < n_c; ++j) out[j] = row[j] - mn;
  }
  costs = norm.data();

  const bool big = static_cast<i64>(n_x) * n_c > 500'000;
  if (method == 3 || (method != 1 && method != 2 && big)) {
    SparseResult sr = constrained_assign_sparse(n_x, n_c, costs, size_min,
                                                size_max,
                                                /*bail_when_dense=*/method != 3);
    if (sr.ok) {
      for (int i = 0; i < n_x; ++i) out_labels[i] = sr.labels[i];
      return 0;
    }
    if (method == 3) return 1;  // forced sparse failed
    // otherwise fall through to the dense solve
  }
  const int x0 = 0;                 // X nodes: [0, n_x)
  const int cd0 = n_x;              // C' dummies: [n_x, n_x + n_c)
  const int c0 = n_x + n_c;         // C nodes
  const int art = n_x + 2 * n_c;    // artificial sink
  Graph g(art + 1);
  g.reserve(static_cast<size_t>(n_x) * n_c + 2 * n_c);

  // X -> C' unit arcs carry the assignment; arc id of (i, j) is 2*(i*n_c+j)
  // because edges are added in row-major order first.
  for (int i = 0; i < n_x; ++i) {
    for (int j = 0; j < n_c; ++j) {
      g.add_edge(x0 + i, cd0 + j, 1, costs[static_cast<i64>(i) * n_c + j]);
    }
  }
  for (int j = 0; j < n_c; ++j) g.add_edge(cd0 + j, c0 + j, size_max, 0);
  for (int j = 0; j < n_c; ++j) g.add_edge(c0 + j, art, n_x, 0);

  std::vector<i64> sup(art + 1, 0);
  for (int i = 0; i < n_x; ++i) sup[x0 + i] = 1;
  for (int j = 0; j < n_c; ++j) sup[c0 + j] = -static_cast<i64>(size_min);
  sup[art] = -(static_cast<i64>(n_x) - static_cast<i64>(n_c) * size_min);

  bool ok;
  if (method == 1) {
    ok = SSP(g, std::move(sup)).solve();
  } else {
    ok = CostScaling(g, std::move(sup)).solve();
  }
  if (!ok) return 1;

  for (int i = 0; i < n_x; ++i) {
    int lab = -1;
    for (int j = 0; j < n_c; ++j) {
      int a = 2 * (static_cast<int>(static_cast<i64>(i) * n_c + j));
      if (g.cap[a ^ 1] > 0) { lab = j; break; }  // unit arc carries flow
    }
    if (lab < 0) return 3;
    out_labels[i] = lab;
  }
  return 0;
}

}  // extern "C"
