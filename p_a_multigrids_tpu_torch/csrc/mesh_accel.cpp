// mesh_accel: the macro mesh's neighbor topology on the host, the port's
// copy of the JAX package's native/mesh_accel.cpp (same C interface).
//
// The Fortran reference's neighbor discovery (CheckNeig, Msh2Tri.F90:780-963)
// is an O(E^2) all-pairs fuzzy vertex match.  This is the O(E) sorted-edge
// hash; mesh/topology.py's _neighbor_topology_py is its plain Python version
// with the identical contract, which the tests hold it to.
//
// Face convention (MACRO_FACE_NODES): face0=edge(n0,n2), face1=edge(n0,n1),
// face2=edge(n1,n2).  dir_flag[e][f] = 1 when the two incident elements
// traverse the shared edge in the same direction.

#include <cstddef>
#include <cstdint>
#include <unordered_map>
#include <vector>

namespace {
struct EdgeInfo {
  int32_t elem;
  int32_t face;
  int32_t first_vertex;  // vertex id at the face's first slot
};
constexpr int kFaceNodes[3][2] = {{0, 2}, {0, 1}, {1, 2}};
}  // namespace

extern "C" int neighbor_topology(const int32_t* tri, int64_t num_elems,
                                 int32_t* neig, int32_t* neigh_face,
                                 uint8_t* dir_flag) {
  std::unordered_map<uint64_t, EdgeInfo> edges;
  edges.reserve(static_cast<size_t>(num_elems) * 2);
  for (int64_t e = 0; e < num_elems; ++e) {
    for (int f = 0; f < 3; ++f) {
      const int32_t a = tri[e * 3 + kFaceNodes[f][0]];
      const int32_t b = tri[e * 3 + kFaceNodes[f][1]];
      const uint64_t lo = static_cast<uint32_t>(a < b ? a : b);
      const uint64_t hi = static_cast<uint32_t>(a < b ? b : a);
      const uint64_t key = (hi << 32) | lo;
      auto it = edges.find(key);
      if (it == edges.end()) {
        edges.emplace(key, EdgeInfo{static_cast<int32_t>(e),
                                    static_cast<int32_t>(f), a});
      } else {
        const EdgeInfo other = it->second;
        edges.erase(it);
        neig[e * 3 + f] = other.elem;
        neig[other.elem * 3 + other.face] = static_cast<int32_t>(e);
        neigh_face[e * 3 + f] = other.face;
        neigh_face[other.elem * 3 + other.face] = static_cast<int32_t>(f);
        const uint8_t same = (a == other.first_vertex) ? 1 : 0;
        dir_flag[e * 3 + f] = same;
        dir_flag[other.elem * 3 + other.face] = same;
      }
    }
  }
  return 0;
}
