// Native SAH BVH builder — the scene compiler's hot path.
//
// Counterpart of the reference's Go builder (asset/compiler/bvh/
// bvh_builder.go:100-308), which fans every split candidate out to its own
// goroutine; here the candidate scan is a tight sequential loop (a single
// core outruns the goroutine version by an order of magnitude at these
// sizes). Semantics match the reference and the NumPy fallback builder
// (polaris_tpu/asset/compiler/bvh.py):
//   * candidate splits per axis at step side/(1024/(depth+1))
//   * SAH score = leftCount*leftArea + rightCount*rightArea,
//     +inf for empty sides; leaf when <= min_leaf items or no candidate
//     improves the parent score
//   * items partitioned by center < split
//
// Output encoding: inner nodes carry child indices in (ldata, rdata);
// leaf nodes carry ldata = -(leaf_ordinal+1), rdata = 0, with the leaf's
// item range in (leaf_first[ordinal], leaf_count[ordinal]) pointing into
// the permutation array. The Python wrapper rewrites leaf payloads through
// the same LeafCallback contract the reference uses.
//
// Exposed via a plain C ABI for ctypes (no pybind11 in this image).

#include <algorithm>
#include <cfloat>
#include <cmath>
#include <cstdint>
#include <vector>

namespace {

constexpr float kMinSideLength = 1e-3f;
constexpr float kMinSplitStep = 1e-5f;

struct Builder {
  const float* bmin;  // [n,3]
  const float* bmax;
  const float* ctr;
  int min_leaf;

  std::vector<float> out_bmin, out_bmax;
  std::vector<int32_t> ldata, rdata;
  std::vector<int32_t> perm;
  std::vector<int32_t> leaf_first, leaf_count;

  static double sah_area(const float s[3]) {
    return (double)s[0] * s[1] + (double)s[1] * s[2] + (double)s[0] * s[2];
  }

  int make_leaf(const float nmin[3], const float nmax[3],
                std::vector<int32_t>& items) {
    int idx = (int)ldata.size();
    for (int k = 0; k < 3; k++) {
      out_bmin.push_back(nmin[k]);
      out_bmax.push_back(nmax[k]);
    }
    int ordinal = (int)leaf_first.size();
    leaf_first.push_back((int32_t)perm.size());
    leaf_count.push_back((int32_t)items.size());
    for (int32_t it : items) perm.push_back(it);
    ldata.push_back(-(ordinal + 1));
    rdata.push_back(0);
    return idx;
  }

  int partition(std::vector<int32_t>& items, int depth) {
    float nmin[3] = {FLT_MAX, FLT_MAX, FLT_MAX};
    float nmax[3] = {-FLT_MAX, -FLT_MAX, -FLT_MAX};
    for (int32_t it : items) {
      for (int k = 0; k < 3; k++) {
        nmin[k] = std::min(nmin[k], bmin[3 * it + k]);
        nmax[k] = std::max(nmax[k], bmax[3 * it + k]);
      }
    }
    if ((int)items.size() <= min_leaf) return make_leaf(nmin, nmax, items);

    float side[3] = {nmax[0] - nmin[0], nmax[1] - nmin[1], nmax[2] - nmin[2]};
    double parent_score = (double)items.size() * sah_area(side);
    double best_score = parent_score;
    int best_axis = -1;
    float best_split = 0.f;

    for (int axis = 0; axis < 3; axis++) {
      if (side[axis] < kMinSideLength) continue;
      float step = side[axis] / (1024.0f / (float)(depth + 1));
      if (step < kMinSplitStep) continue;
      for (double sp = nmin[axis]; sp < (double)nmin[axis] + side[axis];
           sp += step) {
        float lmin[3] = {FLT_MAX, FLT_MAX, FLT_MAX};
        float lmax[3] = {-FLT_MAX, -FLT_MAX, -FLT_MAX};
        float rmin[3] = {FLT_MAX, FLT_MAX, FLT_MAX};
        float rmax[3] = {-FLT_MAX, -FLT_MAX, -FLT_MAX};
        int lc = 0, rc = 0;
        for (int32_t it : items) {
          if (ctr[3 * it + axis] < sp) {
            lc++;
            for (int k = 0; k < 3; k++) {
              lmin[k] = std::min(lmin[k], bmin[3 * it + k]);
              lmax[k] = std::max(lmax[k], bmax[3 * it + k]);
            }
          } else {
            rc++;
            for (int k = 0; k < 3; k++) {
              rmin[k] = std::min(rmin[k], bmin[3 * it + k]);
              rmax[k] = std::max(rmax[k], bmax[3 * it + k]);
            }
          }
        }
        if (lc == 0 || rc == 0) continue;
        float ls[3] = {lmax[0] - lmin[0], lmax[1] - lmin[1], lmax[2] - lmin[2]};
        float rs[3] = {rmax[0] - rmin[0], rmax[1] - rmin[1], rmax[2] - rmin[2]};
        double score = lc * sah_area(ls) + rc * sah_area(rs);
        if (score < best_score) {
          best_score = score;
          best_axis = axis;
          best_split = (float)sp;
        }
      }
    }

    if (best_axis < 0) return make_leaf(nmin, nmax, items);

    std::vector<int32_t> left, right;
    left.reserve(items.size());
    right.reserve(items.size());
    for (int32_t it : items) {
      if (ctr[3 * it + best_axis] < best_split)
        left.push_back(it);
      else
        right.push_back(it);
    }

    int idx = (int)ldata.size();
    for (int k = 0; k < 3; k++) {
      out_bmin.push_back(nmin[k]);
      out_bmax.push_back(nmax[k]);
    }
    ldata.push_back(0);
    rdata.push_back(0);
    int li = partition(left, depth + 1);
    int ri = partition(right, depth + 1);
    ldata[idx] = li;
    rdata[idx] = ri;
    return idx;
  }
};

}  // namespace

extern "C" {

// Returns the node count. Caller passes output buffers sized for the worst
// case: nodes <= 2n-1, perm/leaf arrays <= n.
int polaris_build_bvh(int n, const float* bmin, const float* bmax,
                      const float* ctr, int min_leaf, float* out_bmin,
                      float* out_bmax, int32_t* out_ldata, int32_t* out_rdata,
                      int32_t* out_perm, int32_t* out_leaf_first,
                      int32_t* out_leaf_count, int32_t* out_n_leaves) {
  Builder b;
  b.bmin = bmin;
  b.bmax = bmax;
  b.ctr = ctr;
  b.min_leaf = min_leaf;
  std::vector<int32_t> items(n);
  for (int i = 0; i < n; i++) items[i] = i;
  b.partition(items, 0);

  int n_nodes = (int)b.ldata.size();
  std::copy(b.out_bmin.begin(), b.out_bmin.end(), out_bmin);
  std::copy(b.out_bmax.begin(), b.out_bmax.end(), out_bmax);
  std::copy(b.ldata.begin(), b.ldata.end(), out_ldata);
  std::copy(b.rdata.begin(), b.rdata.end(), out_rdata);
  std::copy(b.perm.begin(), b.perm.end(), out_perm);
  std::copy(b.leaf_first.begin(), b.leaf_first.end(), out_leaf_first);
  std::copy(b.leaf_count.begin(), b.leaf_count.end(), out_leaf_count);
  *out_n_leaves = (int32_t)b.leaf_first.size();
  return n_nodes;
}
}
