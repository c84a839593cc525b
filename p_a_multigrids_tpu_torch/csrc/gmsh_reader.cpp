// gmsh_reader: gmsh 2.x ASCII mesh loader on the host, the port's copy of
// the JAX package's native/gmsh_reader.cpp (same C interface).
//
// The Fortran reference's loader (ReadMSH, Msh2Tri.F90:132-334: $MeshFormat
// check, $Nodes, $Elements with triangle-type filtering and region_id from
// the first tag) in one pass over the file buffer with strtol/strtod: no
// line splitting, no temporary strings.  mesh/gmsh.py's _read_msh_py
// defines which files load; a file this stricter scanner rejects falls
// through to it.
//
// C ABI: gmsh_read() mallocs the output arrays; the caller copies and then
// releases them with gmsh_free().  Returns 0 on success, nonzero with a
// message in errbuf otherwise.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <exception>
#include <vector>

namespace {

// gmsh element types whose first three nodes are triangle corners
// (Msh2Tri.F90:253-308): 2, 9, 20, 21, 23, 24, 25.
bool is_tri_type(long t) {
  return t == 2 || t == 9 || (t >= 20 && t <= 25 && t != 22);
}

struct Scanner {
  const char* p;
  const char* end;

  void skip_ws() {
    while (p < end && (*p == ' ' || *p == '\t' || *p == '\r' || *p == '\n'))
      ++p;
  }
  bool next_long(long* out) {
    skip_ws();
    char* q = nullptr;
    long v = std::strtol(p, &q, 10);
    if (q == p) return false;
    p = q;
    *out = v;
    return true;
  }
  bool next_double(double* out) {
    skip_ws();
    char* q = nullptr;
    double v = std::strtod(p, &q);
    if (q == p) return false;
    p = q;
    *out = v;
    return true;
  }
  void skip_line() {
    while (p < end && *p != '\n') ++p;
    if (p < end) ++p;
  }
  // advance past the line containing the section tag (e.g. "$Nodes")
  bool seek(const char* tag) {
    const size_t n = std::strlen(tag);
    while (p < end) {
      skip_ws();
      if (p + n <= end && std::memcmp(p, tag, n) == 0 &&
          (p + n == end || p[n] == '\n' || p[n] == '\r')) {
        skip_line();
        return true;
      }
      skip_line();
    }
    return false;
  }
};

int fail(char* errbuf, int64_t errlen, const char* msg) {
  if (errbuf && errlen > 0) std::snprintf(errbuf, errlen, "%s", msg);
  return 1;
}

}  // namespace

extern "C" void gmsh_free(double* vertices, int32_t* tris, int32_t* regions) {
  std::free(vertices);
  std::free(tris);
  std::free(regions);
}

namespace {

// Implementation body; may throw (std::bad_alloc from the vectors) — the
// extern "C" wrapper below converts every exception into an error return so
// nothing ever unwinds across the ctypes boundary.
int gmsh_read_impl(const char* path, double** vertices_out,
                   int64_t* nnodes_out, int32_t** tris_out,
                   int32_t** regions_out, int64_t* ntris_out,
                   char* errbuf, int64_t errlen) {
  std::FILE* f = std::fopen(path, "rb");
  if (!f) return fail(errbuf, errlen, "cannot open file");
  std::fseek(f, 0, SEEK_END);
  const long size = std::ftell(f);
  if (size < 0) {
    std::fclose(f);
    return fail(errbuf, errlen, "cannot determine file size");
  }
  std::fseek(f, 0, SEEK_SET);
  std::vector<char> buf(static_cast<size_t>(size) + 1);
  const size_t got = std::fread(buf.data(), 1, static_cast<size_t>(size), f);
  std::fclose(f);
  buf[got] = '\0';

  Scanner s{buf.data(), buf.data() + got};
  if (!s.seek("$MeshFormat"))
    return fail(errbuf, errlen, "section $MeshFormat not found");
  double version = 0.0;
  long filetype = 0, datasize = 0;
  if (!s.next_double(&version) || !s.next_long(&filetype) ||
      !s.next_long(&datasize))
    return fail(errbuf, errlen, "malformed $MeshFormat");
  if (!(version >= 2.0 && version <= 2.2))
    return fail(errbuf, errlen,
                "unsupported gmsh version; only 2.x ASCII is supported");
  if (filetype != 0) return fail(errbuf, errlen, ".msh is binary, not ASCII");

  if (!s.seek("$Nodes")) return fail(errbuf, errlen, "section $Nodes not found");
  long nnodes = 0;
  // count sanity: every node entry occupies at least 4 bytes of file
  // ("i x y z\n" and a count line), so a count exceeding buffer/4 is
  // malformed input — reject instead of attempting a huge allocation
  if (!s.next_long(&nnodes) || nnodes < 0 ||
      static_cast<size_t>(nnodes) > got / 4)
    return fail(errbuf, errlen, "malformed $Nodes count");
  std::vector<double> verts(static_cast<size_t>(nnodes) * 3, 0.0);
  for (long k = 0; k < nnodes; ++k) {
    long idx = 0;
    double x, y, z;
    if (!s.next_long(&idx) || !s.next_double(&x) || !s.next_double(&y) ||
        !s.next_double(&z) || idx < 1 || idx > nnodes)
      return fail(errbuf, errlen, "malformed $Nodes entry");
    verts[(idx - 1) * 3 + 0] = x;
    verts[(idx - 1) * 3 + 1] = y;
    verts[(idx - 1) * 3 + 2] = z;
  }

  if (!s.seek("$Elements"))
    return fail(errbuf, errlen, "section $Elements not found");
  long nelems = 0;
  if (!s.next_long(&nelems) || nelems < 0 ||
      static_cast<size_t>(nelems) > got / 4)
    return fail(errbuf, errlen, "malformed $Elements count");
  std::vector<int32_t> tris;
  std::vector<int32_t> regions;
  tris.reserve(static_cast<size_t>(nelems) * 3);
  regions.reserve(static_cast<size_t>(nelems));
  for (long k = 0; k < nelems; ++k) {
    long id = 0, etype = 0, ntags = 0;
    if (!s.next_long(&id) || !s.next_long(&etype) || !s.next_long(&ntags) ||
        ntags < 0)
      return fail(errbuf, errlen, "malformed $Elements entry");
    long first_tag = 0;
    for (long t = 0; t < ntags; ++t) {
      long tag = 0;
      if (!s.next_long(&tag))
        return fail(errbuf, errlen, "malformed element tags");
      if (t == 0) first_tag = tag;
    }
    if (is_tri_type(etype)) {
      long a, b, c;
      if (!s.next_long(&a) || !s.next_long(&b) || !s.next_long(&c))
        return fail(errbuf, errlen, "malformed triangle connectivity");
      // node ids must reference the $Nodes range, like the $Nodes loop
      if (a < 1 || a > nnodes || b < 1 || b > nnodes || c < 1 || c > nnodes)
        return fail(errbuf, errlen, "triangle node id out of range");
      tris.push_back(static_cast<int32_t>(a - 1));
      tris.push_back(static_cast<int32_t>(b - 1));
      tris.push_back(static_cast<int32_t>(c - 1));
      regions.push_back(static_cast<int32_t>(ntags >= 1 ? first_tag : 0));
      s.skip_line();  // drop any higher-order nodes on the same line
    } else {
      s.skip_line();
    }
  }

  const int64_t ntris = static_cast<int64_t>(regions.size());
  double* verts_arr =
      static_cast<double*>(std::malloc(verts.size() * sizeof(double)));
  int32_t* tris_arr =
      static_cast<int32_t*>(std::malloc(tris.size() * sizeof(int32_t)));
  int32_t* reg_arr =
      static_cast<int32_t*>(std::malloc(regions.size() * sizeof(int32_t)));
  if ((!verts_arr && !verts.empty()) || (!tris_arr && !tris.empty()) ||
      (!reg_arr && !regions.empty())) {
    std::free(verts_arr);
    std::free(tris_arr);
    std::free(reg_arr);
    return fail(errbuf, errlen, "out of memory");
  }
  if (!verts.empty())
    std::memcpy(verts_arr, verts.data(), verts.size() * sizeof(double));
  if (!tris.empty())
    std::memcpy(tris_arr, tris.data(), tris.size() * sizeof(int32_t));
  if (!regions.empty())
    std::memcpy(reg_arr, regions.data(), regions.size() * sizeof(int32_t));

  *vertices_out = verts_arr;
  *nnodes_out = nnodes;
  *tris_out = tris_arr;
  *regions_out = reg_arr;
  *ntris_out = ntris;
  return 0;
}

}  // namespace

extern "C" int gmsh_read(const char* path, double** vertices_out,
                         int64_t* nnodes_out, int32_t** tris_out,
                         int32_t** regions_out, int64_t* ntris_out,
                         char* errbuf, int64_t errlen) {
  *vertices_out = nullptr;
  *tris_out = nullptr;
  *regions_out = nullptr;
  *nnodes_out = 0;
  *ntris_out = 0;
  try {
    return gmsh_read_impl(path, vertices_out, nnodes_out, tris_out,
                          regions_out, ntris_out, errbuf, errlen);
  } catch (const std::exception& e) {
    return fail(errbuf, errlen, e.what());
  } catch (...) {
    return fail(errbuf, errlen, "native loader exception");
  }
}
