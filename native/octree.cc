// Exact DistributeOctTree as a native C++ component.
//
// Host-side replacement for the greedy quadtree keypoint balancing
// (reference: ORBextractor::DistributeOctTree, src/orb_extractor/
// ORBextractor.cc:544-771 and ExtractorNode::DivideNode :486-542).
// The algorithm is inherently sequential (list mutation, largest-first
// final stage), so the host-exact path runs natively; the device pipeline
// uses the shape-static device approximation in frontend/octree.py.
//
// Ordering spec: the reference's final stage sorts (size, node*) pairs,
// so equal-size ties compare std::list node POINTERS — unspecified
// behaviour.  We pin a deterministic spec shared with the python
// implementation (frontend/octree.py:_distribute_host_py): node lists
// are built in forward order (children appended n1..n4 at the end) and
// equal-size ties in the final stage expand in reverse insertion order.
// Leaf SETS therefore match python exactly and match the reference
// except on exact size ties.
//
// C ABI for ctypes:
//   int distribute_octree(const float* xs, const float* ys,
//                         const float* resp, int n,
//                         int min_x, int max_x, int min_y, int max_y,
//                         int n_target, long long* out_idx, int max_out);
// Returns the number of selected keypoints (indices into the input
// arrays, one per leaf node), or -1 on error.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <deque>
#include <vector>

namespace {

struct Node {
  int ulx, uly, brx, bry;
  std::vector<int> idx;
  bool no_more = false;
};

// Pool keeps nodes alive for the whole call; lists hold raw pointers.
using Pool = std::deque<Node>;

Node* make_node(Pool& pool, int ulx, int uly, int brx, int bry,
                std::vector<int> idx) {
  pool.push_back(Node{ulx, uly, brx, bry, std::move(idx)});
  Node* n = &pool.back();
  n->no_more = n->idx.size() == 1;
  return n;
}

// ExtractorNode::DivideNode (ceil halving), children in n1..n4 order.
void divide(Pool& pool, const Node* n, const float* xs, const float* ys,
            Node* out[4]) {
  const int half_x =
      static_cast<int>(std::ceil(static_cast<float>(n->brx - n->ulx) / 2));
  const int half_y =
      static_cast<int>(std::ceil(static_cast<float>(n->bry - n->uly) / 2));
  const int mx = n->ulx + half_x;
  const int my = n->uly + half_y;
  std::vector<int> c0, c1, c2, c3;
  for (int i : n->idx) {
    const bool left = xs[i] < static_cast<float>(mx);
    const bool top = ys[i] < static_cast<float>(my);
    (left ? (top ? c0 : c2) : (top ? c1 : c3)).push_back(i);
  }
  out[0] = make_node(pool, n->ulx, n->uly, mx, my, std::move(c0));
  out[1] = make_node(pool, mx, n->uly, n->brx, my, std::move(c1));
  out[2] = make_node(pool, n->ulx, my, mx, n->bry, std::move(c2));
  out[3] = make_node(pool, mx, my, n->brx, n->bry, std::move(c3));
}

}  // namespace

extern "C" int distribute_octree(
    const float* xs_in, const float* ys_in, const float* resp, int n,
    int min_x, int max_x, int min_y, int max_y, int n_target,
    long long* out_idx, int max_out) {
  if (n <= 0 || n_target <= 0) return 0;

  std::vector<float> xs(n), ys(n);
  for (int i = 0; i < n; ++i) {
    xs[i] = xs_in[i] - static_cast<float>(min_x);
    ys[i] = ys_in[i] - static_cast<float>(min_y);
  }
  const int w = max_x - min_x;
  const int h = max_y - min_y;
  int n_ini = static_cast<int>(
      std::lround(static_cast<float>(w) / static_cast<float>(h)));
  if (n_ini < 1) n_ini = 1;
  const float h_x = static_cast<float>(w) / static_cast<float>(n_ini);

  Pool pool;
  std::vector<std::vector<int>> buckets(n_ini);
  for (int i = 0; i < n; ++i) {
    int col = static_cast<int>(xs[i] / h_x);
    if (col < 0) col = 0;
    if (col >= n_ini) col = n_ini - 1;
    buckets[col].push_back(i);
  }
  std::vector<Node*> nodes;
  for (int i = 0; i < n_ini; ++i) {
    const int ulx = static_cast<int>(h_x * static_cast<float>(i));
    const int brx = static_cast<int>(h_x * static_cast<float>(i + 1));
    Node* node = make_node(pool, ulx, 0, brx, h, std::move(buckets[i]));
    if (!node->idx.empty()) nodes.push_back(node);
  }

  bool finish = false;
  std::vector<Node*> to_expand;
  while (!finish) {
    const int prev_size = static_cast<int>(nodes.size());
    std::vector<Node*> new_nodes;
    to_expand.clear();
    for (Node* node : nodes) {
      if (node->no_more) {
        new_nodes.push_back(node);
        continue;
      }
      Node* children[4];
      divide(pool, node, xs.data(), ys.data(), children);
      for (int c = 0; c < 4; ++c) {
        if (children[c]->idx.empty()) continue;
        new_nodes.push_back(children[c]);
        if (children[c]->idx.size() > 1) to_expand.push_back(children[c]);
      }
    }
    nodes.swap(new_nodes);
    if (static_cast<int>(nodes.size()) >= n_target ||
        static_cast<int>(nodes.size()) == prev_size) {
      finish = true;
    } else if (static_cast<int>(nodes.size()) +
                   3 * static_cast<int>(to_expand.size()) >
               n_target) {
      // final stage: expand largest nodes first; equal sizes in reverse
      // insertion order (stable ascending sort, then iterate backwards)
      while (!finish) {
        const int prev2 = static_cast<int>(nodes.size());
        std::vector<Node*> prev_expand = to_expand;
        to_expand.clear();
        std::stable_sort(prev_expand.begin(), prev_expand.end(),
                         [](const Node* a, const Node* b) {
                           return a->idx.size() < b->idx.size();
                         });
        for (auto it = prev_expand.rbegin(); it != prev_expand.rend(); ++it) {
          Node* node = *it;
          nodes.erase(std::find(nodes.begin(), nodes.end(), node));
          Node* children[4];
          divide(pool, node, xs.data(), ys.data(), children);
          for (int c = 0; c < 4; ++c) {
            if (children[c]->idx.empty()) continue;
            nodes.push_back(children[c]);
            if (children[c]->idx.size() > 1) to_expand.push_back(children[c]);
          }
          if (static_cast<int>(nodes.size()) >= n_target) break;
        }
        if (static_cast<int>(nodes.size()) >= n_target ||
            static_cast<int>(nodes.size()) == prev2)
          finish = true;
      }
    }
  }

  int count = 0;
  for (const Node* node : nodes) {
    if (count >= max_out) break;
    int best = node->idx[0];
    float best_r = resp[best];
    for (size_t k = 1; k < node->idx.size(); ++k) {
      if (resp[node->idx[k]] > best_r) {
        best = node->idx[k];
        best_r = resp[best];
      }
    }
    out_idx[count++] = best;
  }
  return count;
}
