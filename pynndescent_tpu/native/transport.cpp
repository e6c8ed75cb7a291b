// Exact optimal transport (Kantorovich / EMD) for dense bipartite problems.
//
// Native replacement for the reference's numba-compiled network simplex
// (reference: pynndescent/optimal_transport.py:846 network_simplex_core).
// The algorithm here is successive shortest augmenting paths with node
// potentials (a classical min-cost-flow method): pointer-chasing and
// data-dependent control flow make this hostile to XLA, so it lives in C++
// on the host while Sinkhorn (matrix scaling) runs on the device.
//
// Exposed C ABI:
//   double emd_dense(int n1, int n2, const double* a, const double* b,
//                    const double* cost, double* flow_out /* may be null */);
//
// a[0..n1) and b[0..n2) must be nonnegative and sum to the same total
// (the Python wrapper normalises). cost is row-major [n1, n2]. Returns the
// optimal transport cost, or a negative value on error.

#include <cmath>
#include <cstring>
#include <limits>
#include <vector>

namespace {

constexpr double kInf = std::numeric_limits<double>::infinity();
constexpr double kMassEps = 1e-12;

}  // namespace

extern "C" double emd_dense(int n1, int n2, const double* a, const double* b,
                            const double* cost, double* flow_out) {
  if (n1 <= 0 || n2 <= 0) return -1.0;

  std::vector<double> rem_a(a, a + n1);
  std::vector<double> rem_b(b, b + n2);
  std::vector<double> pot_u(n1, 0.0);  // source-side potentials
  std::vector<double> pot_v(n2, 0.0);  // sink-side potentials
  std::vector<double> flow;
  if (flow_out) {
    std::memset(flow_out, 0, sizeof(double) * n1 * n2);
  } else {
    flow.assign((size_t)n1 * n2, 0.0);
  }
  double* F = flow_out ? flow_out : flow.data();

  double total = 0.0;
  for (int i = 0; i < n1; ++i) total += a[i];

  // Initialise potentials so all reduced costs are nonnegative:
  // pot_v[j] = min_i cost[i][j] with pot_u = 0.
  for (int j = 0; j < n2; ++j) {
    double m = kInf;
    for (int i = 0; i < n1; ++i) m = std::min(m, cost[(size_t)i * n2 + j]);
    pot_v[j] = m;
  }

  double moved = 0.0;
  double obj = 0.0;
  const int n = n1 + n2;
  std::vector<double> dist(n);
  std::vector<int> parent(n);
  std::vector<char> done(n);

  long guard = 16L * (n1 + n2) + 64;
  while (total - moved > kMassEps * std::max(1.0, total) && guard-- > 0) {
    // Dijkstra over the residual graph with reduced costs.
    // Nodes 0..n1-1 are sources, n1..n1+n2-1 are sinks. Implicit super
    // source connects to every source with remaining supply at cost 0.
    std::fill(dist.begin(), dist.end(), kInf);
    std::fill(parent.begin(), parent.end(), -1);
    std::fill(done.begin(), done.end(), 0);
    for (int i = 0; i < n1; ++i)
      if (rem_a[i] > kMassEps) dist[i] = 0.0;

    int best_sink = -1;
    for (int iter = 0; iter < n; ++iter) {
      int u = -1;
      double du = kInf;
      for (int x = 0; x < n; ++x)
        if (!done[x] && dist[x] < du) { du = dist[x]; u = x; }
      if (u < 0) break;
      done[u] = 1;
      if (u >= n1 && rem_b[u - n1] > kMassEps) {
        best_sink = u;  // shortest path to an unsaturated sink found
        break;
      }
      if (u < n1) {
        // forward arcs i -> j (infinite capacity), length = reduced cost
        // rc = c_ij - u_i - v_j >= 0 (clamped against float drift)
        const double* crow = cost + (size_t)u * n2;
        for (int j = 0; j < n2; ++j) {
          int v = n1 + j;
          if (done[v]) continue;
          double rc = crow[j] - pot_u[u] - pot_v[j];
          double nd = du + (rc > 0.0 ? rc : 0.0);
          if (nd < dist[v] - 1e-15) { dist[v] = nd; parent[v] = u; }
        }
      } else {
        // backward arcs j -> i (only where flow > 0), length = -rc = 0 on
        // flow-carrying arcs by the invariant (clamped)
        int j = u - n1;
        for (int i = 0; i < n1; ++i) {
          if (done[i]) continue;
          double f = F[(size_t)i * n2 + j];
          if (f <= kMassEps) continue;
          double rc = cost[(size_t)i * n2 + j] - pot_u[i] - pot_v[j];
          double nd = du + (rc < 0.0 ? -rc : 0.0);
          if (nd < dist[i] - 1e-15) { dist[i] = nd; parent[i] = u; }
        }
      }
    }
    if (best_sink < 0) return -2.0;  // disconnected / numerical failure

    // Dual update maintaining complementary slackness (rc = c - u - v = 0 on
    // flow-carrying arcs, >= 0 elsewhere). For a shortest-path arc (i -> j),
    // rc = d_j - d_i, and the update u_i += (D - d_i), v_j -= (D - d_j) with
    // D = d(sink) zeroes it; clamping at D keeps unlabelled nodes unchanged.
    double dsink = dist[best_sink];
    for (int i = 0; i < n1; ++i)
      pot_u[i] += dsink - std::min(dist[i], dsink);
    for (int j = 0; j < n2; ++j)
      pot_v[j] -= dsink - std::min(dist[n1 + j], dsink);

    // Find bottleneck along the path.
    double push = kInf;
    int v = best_sink;
    push = std::min(push, rem_b[best_sink - n1]);
    while (parent[v] >= 0) {
      int p = parent[v];
      if (v >= n1) {
        // arc p(source) -> v(sink): infinite capacity
      } else {
        // arc p(sink) -> v(source): backward, limited by flow
        push = std::min(push, F[(size_t)v * n2 + (p - n1)]);
      }
      v = p;
    }
    push = std::min(push, rem_a[v]);  // v is the root source
    if (!(push > kMassEps)) return -3.0;

    // Apply the augmentation.
    int node = best_sink;
    while (parent[node] >= 0) {
      int p = parent[node];
      if (node >= n1) {
        F[(size_t)p * n2 + (node - n1)] += push;
      } else {
        F[(size_t)node * n2 + (p - n1)] -= push;
      }
      node = p;
    }
    rem_a[node] -= push;
    rem_b[best_sink - n1] -= push;
    moved += push;
  }

  // Guard exhausted with mass still untransported: the partial flow's cost
  // would silently underestimate the true EMD. Signal failure so the Python
  // wrapper falls through to the exact LP path.
  if (total - moved > kMassEps * std::max(1.0, total)) return -4.0;

  for (int i = 0; i < n1; ++i)
    for (int j = 0; j < n2; ++j) obj += F[(size_t)i * n2 + j] * cost[(size_t)i * n2 + j];
  return obj;
}
