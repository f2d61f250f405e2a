// Morton-ordered adaptive quad/octree forest: the counterpart of p4est +
// parallel::distributed::Triangulation (the reference's AMR engine, SURVEY.md
// section 2.3); the port's own copy of the JAX package's native forest.
// Host-side C++ (the mesh is rebuilt rarely; device code only consumes the
// flat index maps built from this code's queries):
//
//  - forest of root cells on a structured coarse grid,
//  - refine/coarsen by flags with 2:1 balance enforcement,
//  - Morton (z-order) enumeration of active cells,
//  - face-neighbor queries across levels,
//  - per-cell geometry (anchor + level) for index-map construction in Python.
//
// Exposed through a C ABI for ctypes (no pybind11 in this image).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <map>
#include <set>
#include <vector>

namespace {

struct Cell {
  // root cell coordinates and refinement path
  int32_t root_x, root_y, root_z;
  int32_t level;
  // anchor in units of the finest lattice within the root (2^level per root)
  int64_t x, y, z;
};

struct Forest {
  int dim;
  int32_t n_roots[3];
  int max_level = 0;
  // active cells keyed by (root, level, anchor) in Morton order
  std::vector<Cell> cells;
  // a number no other state of any forest of this process had: set at
  // creation and at every adapt, it keys the face-neighbor lookup's cache
  uint64_t generation = 0;
};

uint64_t next_generation() {
  static uint64_t counter = 0;
  return ++counter;
}

inline uint64_t interleave2(uint32_t a, uint32_t b) {
  uint64_t out = 0;
  for (int i = 0; i < 32; ++i) {
    out |= ((uint64_t)(a >> i) & 1ull) << (2 * i);
    out |= ((uint64_t)(b >> i) & 1ull) << (2 * i + 1);
  }
  return out;
}

inline uint64_t interleave3(uint32_t a, uint32_t b, uint32_t c) {
  uint64_t out = 0;
  for (int i = 0; i < 21; ++i) {
    out |= ((uint64_t)(a >> i) & 1ull) << (3 * i);
    out |= ((uint64_t)(b >> i) & 1ull) << (3 * i + 1);
    out |= ((uint64_t)(c >> i) & 1ull) << (3 * i + 2);
  }
  return out;
}

// global ordering key: roots lexicographic, then Morton within the root at
// the finest resolution
struct Key {
  uint64_t root;
  uint64_t morton;
  int32_t level;
  bool operator<(const Key& o) const {
    if (root != o.root) return root < o.root;
    if (morton != o.morton) return morton < o.morton;
    return level < o.level;
  }
};

Key key_of(const Forest& f, const Cell& c) {
  Key k;
  k.root = ((uint64_t)c.root_z * f.n_roots[1] + c.root_y) * f.n_roots[0] +
           c.root_x;
  // normalize anchors to a fixed fine resolution (level 30 in 2D, 20 in 3D)
  const int L = f.dim == 2 ? 30 : 20;
  uint32_t xs = (uint32_t)(c.x << (L - c.level));
  uint32_t ys = (uint32_t)(c.y << (L - c.level));
  if (f.dim == 2)
    k.morton = interleave2(xs, ys);
  else
    k.morton = interleave3(xs, ys, (uint32_t)(c.z << (L - c.level)));
  k.level = c.level;
  return k;
}

void sort_cells(Forest& f) {
  std::sort(f.cells.begin(), f.cells.end(), [&](const Cell& a, const Cell& b) {
    return key_of(f, a) < key_of(f, b);
  });
}

// neighbor lookup: returns indices of active cells adjacent to `c` across
// the face (axis, side). Cells are located via a map from (root, level,
// anchor).
struct Locator {
  std::map<std::tuple<int64_t, int32_t, int64_t, int64_t, int64_t>, int32_t>
      by_id;
  void build(const Forest& f) {
    by_id.clear();
    for (size_t i = 0; i < f.cells.size(); ++i) {
      const Cell& c = f.cells[i];
      int64_t root = ((int64_t)c.root_z * f.n_roots[1] + c.root_y) *
                         f.n_roots[0] +
                     c.root_x;
      by_id[{root, c.level, c.x, c.y, c.z}] = (int32_t)i;
    }
  }
};

}  // namespace

extern "C" {

Forest* forest_create(int dim, int nx, int ny, int nz) {
  Forest* f = new Forest();
  f->dim = dim;
  f->n_roots[0] = nx;
  f->n_roots[1] = ny;
  f->n_roots[2] = dim == 3 ? nz : 1;
  for (int z = 0; z < f->n_roots[2]; ++z)
    for (int y = 0; y < ny; ++y)
      for (int x = 0; x < nx; ++x)
        f->cells.push_back({x, y, z, 0, 0, 0, 0});
  sort_cells(*f);
  f->generation = next_generation();
  return f;
}

void forest_destroy(Forest* f) { delete f; }

int64_t forest_n_cells(const Forest* f) { return (int64_t)f->cells.size(); }
int forest_max_level(const Forest* f) { return f->max_level; }

// fills per-cell data: root indices (3), level, anchor (3)
void forest_get_cells(const Forest* f, int32_t* roots, int32_t* levels,
                      int64_t* anchors) {
  for (size_t i = 0; i < f->cells.size(); ++i) {
    const Cell& c = f->cells[i];
    roots[3 * i] = c.root_x;
    roots[3 * i + 1] = c.root_y;
    roots[3 * i + 2] = c.root_z;
    levels[i] = c.level;
    anchors[3 * i] = c.x;
    anchors[3 * i + 1] = c.y;
    anchors[3 * i + 2] = c.z;
  }
}

// refine cells flagged 1, coarsen sibling groups all flagged -1 (2:1 balance
// enforced afterwards). Returns the new number of cells.
int64_t forest_adapt(Forest* f, const int8_t* flags) {
  const int dim = f->dim;
  const int n_children = dim == 2 ? 4 : 8;
  std::vector<Cell> next;
  next.reserve(f->cells.size() * 2);

  // coarsening: group siblings (same parent) where ALL are flagged -1
  std::set<size_t> skip;
  {
    std::map<std::tuple<int64_t, int32_t, int64_t, int64_t, int64_t>,
             std::vector<size_t>>
        parents;
    for (size_t i = 0; i < f->cells.size(); ++i) {
      const Cell& c = f->cells[i];
      if (flags[i] == -1 && c.level > 0) {
        int64_t root = ((int64_t)c.root_z * f->n_roots[1] + c.root_y) *
                           f->n_roots[0] +
                       c.root_x;
        parents[{root, c.level - 1, c.x >> 1, c.y >> 1, c.z >> 1}].push_back(i);
      }
    }
    for (auto& kv : parents) {
      if ((int)kv.second.size() == n_children) {
        const Cell& c0 = f->cells[kv.second[0]];
        Cell parent = c0;
        parent.level -= 1;
        parent.x >>= 1;
        parent.y >>= 1;
        parent.z >>= 1;
        next.push_back(parent);
        for (size_t idx : kv.second) skip.insert(idx);
      }
    }
  }

  for (size_t i = 0; i < f->cells.size(); ++i) {
    if (skip.count(i)) continue;
    const Cell& c = f->cells[i];
    if (flags[i] == 1) {
      for (int ch = 0; ch < n_children; ++ch) {
        Cell k = c;
        k.level += 1;
        k.x = 2 * c.x + (ch & 1);
        k.y = 2 * c.y + ((ch >> 1) & 1);
        k.z = dim == 3 ? 2 * c.z + ((ch >> 2) & 1) : 0;
        next.push_back(k);
      }
    } else {
      next.push_back(c);
    }
  }
  f->cells.swap(next);

  // 2:1 balance: repeatedly refine cells with a neighbor more than one
  // level finer. The balance is FULL (faces, edges and corners), matching
  // deal.II's p4est usage (P4EST_CONNECT_FULL): corner-only level jumps of
  // two are also smoothed away.
  bool changed = true;
  while (changed) {
    changed = false;
    sort_cells(*f);
    Locator loc;
    loc.build(*f);
    std::vector<char> refine(f->cells.size(), 0);
    const int n_off = dim == 3 ? 27 : 9;
    for (size_t i = 0; i < f->cells.size(); ++i) {
      const Cell& c = f->cells[i];
      // examine every neighbor position (face/edge/corner offsets): if any
      // active cell exists at level >= c.level+2 touching c, c must refine
      bool found = false;
      for (int off = 0; off < n_off && !found; ++off) {
        int o[3] = {off % 3 - 1, (off / 3) % 3 - 1, dim == 3 ? off / 9 - 1 : 0};
        if (o[0] == 0 && o[1] == 0 && o[2] == 0) continue;
        int64_t nc[3] = {c.x + o[0], c.y + o[1], c.z + o[2]};
        int32_t rr[3] = {c.root_x, c.root_y, c.root_z};
        int64_t span = 1ll << c.level;
        for (int a = 0; a < 3; ++a) {
          if (nc[a] < 0) { rr[a] -= 1; nc[a] = span - 1; }
          if (nc[a] >= span) { rr[a] += 1; nc[a] = 0; }
        }
        if (rr[0] < 0 || rr[0] >= f->n_roots[0] || rr[1] < 0 ||
            rr[1] >= f->n_roots[1] || rr[2] < 0 || rr[2] >= f->n_roots[2])
          continue;
        int64_t root =
            ((int64_t)rr[2] * f->n_roots[1] + rr[1]) * f->n_roots[0] + rr[0];
        // grandchild anchors (level c.level+2) of the neighbor that touch c:
        // offset -1 -> the high face (coordinate +3), +1 -> the low face
        // (coordinate +0), 0 -> all 4 coordinates
        int64_t g0[3], cnt[3];
        for (int a = 0; a < 3; ++a) {
          int64_t base = nc[a] << 2;
          if (o[a] == -1) { g0[a] = base + 3; cnt[a] = 1; }
          else if (o[a] == 1) { g0[a] = base; cnt[a] = 1; }
          else { g0[a] = base; cnt[a] = (a < dim) ? 4 : 1; }
        }
        for (int u = 0; u < cnt[0] && !found; ++u)
          for (int v = 0; v < cnt[1] && !found; ++v)
            for (int w = 0; w < cnt[2] && !found; ++w) {
              int64_t gx = g0[0] + u, gy = g0[1] + v, gz = g0[2] + w;
              // an active cell at level c.level+2 with this anchor? deeper
              // descendants checked one level down; balance iterates to a
              // fixed point so exact-level probes suffice
              if (loc.by_id.count({root, c.level + 2, gx, gy, gz})) found = true;
              if (loc.by_id.count({root, c.level + 3, gx << 1, gy << 1, gz << 1}))
                found = true;
            }
      }
      if (found) refine[i] = 1;
    }
    std::vector<Cell> balanced;
    for (size_t i = 0; i < f->cells.size(); ++i) {
      const Cell& c = f->cells[i];
      if (refine[i]) {
        changed = true;
        for (int ch = 0; ch < n_children; ++ch) {
          Cell k = c;
          k.level += 1;
          k.x = 2 * c.x + (ch & 1);
          k.y = 2 * c.y + ((ch >> 1) & 1);
          k.z = dim == 3 ? 2 * c.z + ((ch >> 2) & 1) : 0;
          balanced.push_back(k);
        }
      } else {
        balanced.push_back(c);
      }
    }
    f->cells.swap(balanced);
  }
  sort_cells(*f);
  f->generation = next_generation();
  f->max_level = 0;
  for (const Cell& c : f->cells)
    f->max_level = std::max(f->max_level, (int)c.level);
  return (int64_t)f->cells.size();
}

// face neighbors: for active cell i and face (axis, side), writes up to
// 2^(dim-1) neighbor indices (or -1); returns the count. relation: 0 same
// level, -1 coarser neighbor, +1 finer neighbors.
int forest_face_neighbors(const Forest* f, int64_t i, int axis, int side,
                          int32_t* out, int32_t* relation) {
  // the lookup map of the last forest state queried; keyed by its
  // generation, not by its address and cell count, which a freed forest's
  // successor or an adapt that keeps the count can repeat
  static thread_local Locator loc;
  static thread_local uint64_t cached = 0;
  if (cached != f->generation) {
    loc.build(*f);
    cached = f->generation;
  }
  const Cell& c = f->cells[i];
  const int dim = f->dim;
  int64_t nx = c.x + (axis == 0 ? (side ? 1 : -1) : 0);
  int64_t ny = c.y + (axis == 1 ? (side ? 1 : -1) : 0);
  int64_t nz = c.z + (axis == 2 ? (side ? 1 : -1) : 0);
  int32_t rx = c.root_x, ry = c.root_y, rz = c.root_z;
  int64_t span = 1ll << c.level;
  if (nx < 0) { rx -= 1; nx = span - 1; }
  if (nx >= span) { rx += 1; nx = 0; }
  if (ny < 0) { ry -= 1; ny = span - 1; }
  if (ny >= span) { ry += 1; ny = 0; }
  if (nz < 0) { rz -= 1; nz = span - 1; }
  if (nz >= span) { rz += 1; nz = 0; }
  if (rx < 0 || rx >= f->n_roots[0] || ry < 0 || ry >= f->n_roots[1] ||
      rz < 0 || rz >= f->n_roots[2]) {
    *relation = 0;
    return 0;  // domain boundary
  }
  int64_t root = ((int64_t)rz * f->n_roots[1] + ry) * f->n_roots[0] + rx;
  // same level?
  auto it = loc.by_id.find({root, c.level, nx, ny, nz});
  if (it != loc.by_id.end()) {
    out[0] = it->second;
    *relation = 0;
    return 1;
  }
  // coarser?
  if (c.level > 0) {
    auto itc = loc.by_id.find({root, c.level - 1, nx >> 1, ny >> 1, nz >> 1});
    if (itc != loc.by_id.end()) {
      out[0] = itc->second;
      *relation = -1;
      return 1;
    }
  }
  // finer children on the touching face
  int count = 0;
  for (int u = 0; u < 2; ++u) {
    for (int v = 0; v < (dim == 3 ? 2 : 1); ++v) {
      int64_t gx, gy, gz;
      if (axis == 0) {
        gx = 2 * nx + (side ? 0 : 1);
        gy = 2 * ny + u;
        gz = dim == 3 ? 2 * nz + v : 0;
      } else if (axis == 1) {
        gy = 2 * ny + (side ? 0 : 1);
        gx = 2 * nx + u;
        gz = dim == 3 ? 2 * nz + v : 0;
      } else {
        gz = 2 * nz + (side ? 0 : 1);
        gx = 2 * nx + u;
        gy = 2 * ny + v;
      }
      auto itf = loc.by_id.find({root, c.level + 1, gx, gy, gz});
      if (itf != loc.by_id.end()) out[count++] = itf->second;
    }
  }
  *relation = 1;
  return count;
}

}  // extern "C"
