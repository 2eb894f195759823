// Threaded-BVH builder — C++ runtime component (SURVEY.md §2.2 "Accel
// grid/BVH": the reference's accelerator build is native; ours too).
// Semantics are byte-identical to the NumPy fallback in
// raytracer/accel/bvh.py: same median split (stable sort on the widest
// centroid axis), same preorder node allocation (children allocated when the
// parent splits, left-first DFS), same per-octant hit/miss threading — so the
// two builders produce identical arrays and renders can never depend on which
// one ran.

#include <algorithm>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

struct Node {
  double bmin[3], bmax[3];
  int left = -1, right = -1;
  int axis = 0;
  int lo = 0, hi = 0;  // leaf triangle range into `order`
};

}  // namespace

extern "C" {

// Returns 0 on success. All *_out buffers are malloc'd here; caller frees via
// rt_free. Layouts match BVHData: aabb f32 [n,3]; leaf_tris i32 [n,leaf]
// (sentinel nt); hit/miss links i32 [8*n] (sentinel n).
int rt_bvh_build(const float* verts, int nv, const int* tris, int nt,
                 int leaf_size, float** aabb_min_out, float** aabb_max_out,
                 int** leaf_tris_out, int** hit_out, int** miss_out,
                 int* n_nodes_out) {
  (void)nv;
  if (nt <= 0 || leaf_size <= 0) return 2;
  std::vector<double> tmin(3 * nt), tmax(3 * nt), cent(3 * nt);
  for (int i = 0; i < nt; ++i) {
    for (int a = 0; a < 3; ++a) {
      double p0 = verts[3 * tris[3 * i] + a];
      double p1 = verts[3 * tris[3 * i + 1] + a];
      double p2 = verts[3 * tris[3 * i + 2] + a];
      double lo = std::min(p0, std::min(p1, p2));
      double hi = std::max(p0, std::max(p1, p2));
      tmin[3 * i + a] = lo;
      tmax[3 * i + a] = hi;
      cent[3 * i + a] = (lo + hi) * 0.5;
    }
  }

  std::vector<int> order(nt);
  for (int i = 0; i < nt; ++i) order[i] = i;
  std::vector<Node> nodes;
  nodes.reserve(2 * ((nt + leaf_size - 1) / leaf_size));

  // Explicit DFS identical to the Python builder: pop order is left-first;
  // children are allocated at split time (preorder ids).
  struct Item {
    int node, lo, hi;
  };
  std::vector<Item> stack;
  nodes.push_back(Node{});
  stack.push_back({0, 0, nt});
  while (!stack.empty()) {
    Item it = stack.back();
    stack.pop_back();
    Node& n0 = nodes[it.node];
    n0.lo = it.lo;
    n0.hi = it.hi;
    for (int a = 0; a < 3; ++a) {
      double lo = tmin[3 * order[it.lo] + a];
      double hi = tmax[3 * order[it.lo] + a];
      for (int k = it.lo + 1; k < it.hi; ++k) {
        lo = std::min(lo, tmin[3 * order[k] + a]);
        hi = std::max(hi, tmax[3 * order[k] + a]);
      }
      n0.bmin[a] = lo;
      n0.bmax[a] = hi;
    }
    if (it.hi - it.lo <= leaf_size) continue;
    // widest centroid axis (ties → lowest axis, matching np.argmax)
    double ext[3];
    for (int a = 0; a < 3; ++a) {
      double lo = cent[3 * order[it.lo] + a], hi = lo;
      for (int k = it.lo + 1; k < it.hi; ++k) {
        lo = std::min(lo, cent[3 * order[k] + a]);
        hi = std::max(hi, cent[3 * order[k] + a]);
      }
      ext[a] = hi - lo;
    }
    int ax = 0;
    if (ext[1] > ext[ax]) ax = 1;
    if (ext[2] > ext[ax]) ax = 2;
    nodes[it.node].axis = ax;
    std::stable_sort(order.begin() + it.lo, order.begin() + it.hi,
                     [&](int a, int b) {
                       return cent[3 * a + ax] < cent[3 * b + ax];
                     });
    int mid = it.lo + (it.hi - it.lo) / 2;
    int l = (int)nodes.size();
    nodes.push_back(Node{});
    int r = (int)nodes.size();
    nodes.push_back(Node{});
    nodes[it.node].left = l;
    nodes[it.node].right = r;
    stack.push_back({r, mid, it.hi});
    stack.push_back({l, it.lo, mid});
  }

  const int n = (int)nodes.size();
  float* amin = (float*)std::malloc(sizeof(float) * 3 * n);
  float* amax = (float*)std::malloc(sizeof(float) * 3 * n);
  int* leaf = (int*)std::malloc(sizeof(int) * (size_t)n * leaf_size);
  int* hit = (int*)std::malloc(sizeof(int) * 8 * (size_t)n);
  int* miss = (int*)std::malloc(sizeof(int) * 8 * (size_t)n);
  if (!amin || !amax || !leaf || !hit || !miss) {
    std::free(amin);
    std::free(amax);
    std::free(leaf);
    std::free(hit);
    std::free(miss);
    return 1;
  }
  for (int i = 0; i < n; ++i) {
    for (int a = 0; a < 3; ++a) {
      amin[3 * i + a] = (float)nodes[i].bmin[a];
      amax[3 * i + a] = (float)nodes[i].bmax[a];
    }
    for (int k = 0; k < leaf_size; ++k) leaf[(size_t)i * leaf_size + k] = nt;
    if (nodes[i].left < 0)
      for (int k = nodes[i].lo; k < nodes[i].hi; ++k)
        leaf[(size_t)i * leaf_size + (k - nodes[i].lo)] = order[k];
  }

  // per-octant threading (bit a of o == 1 ⇔ dir[a] < 0 ⇒ near = right child)
  std::vector<Item> tstack;  // reuse: node, escape in `lo`
  for (int o = 0; o < 8; ++o) {
    tstack.clear();
    tstack.push_back({0, n, 0});
    while (!tstack.empty()) {
      int node = tstack.back().node, escape = tstack.back().lo;
      tstack.pop_back();
      if (nodes[node].left < 0) {
        hit[(size_t)o * n + node] = escape;
        miss[(size_t)o * n + node] = escape;
        continue;
      }
      int bit = (o >> nodes[node].axis) & 1;
      int near = bit == 0 ? nodes[node].left : nodes[node].right;
      int far = bit == 0 ? nodes[node].right : nodes[node].left;
      hit[(size_t)o * n + node] = near;
      miss[(size_t)o * n + node] = escape;
      tstack.push_back({far, escape, 0});
      tstack.push_back({near, far, 0});
    }
  }

  *aabb_min_out = amin;
  *aabb_max_out = amax;
  *leaf_tris_out = leaf;
  *hit_out = hit;
  *miss_out = miss;
  *n_nodes_out = n;
  return 0;
}

}  // extern "C"
