// Fast OBJ parser — the C++ runtime component mirroring the reference's native
// loader (SURVEY.md §2.2 "OBJ loader"). Exposed via a C ABI consumed by
// raytracer/utils/native.py (ctypes); raytracer/io/obj.py holds the
// Python fallback with identical semantics (fan triangulation, negative
// indices, vertex-aligned `vn` kept, else dropped).

#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Corner {
  int v;
  int n;  // 0 = absent (1-based otherwise, may be negative)
};

int fixIndex(int i, int count) { return i > 0 ? i - 1 : count + i; }

}  // namespace

extern "C" {

// Returns 0 on success. Outputs are malloc'd; caller frees via rt_free.
// normals_out is non-null only when every face carries vn indices that map
// 1:1 onto vertex indices (i.e. our own exports) — matching the Python parser.
int rt_load_obj(const char* path, float** verts_out, int* n_verts,
                int** tris_out, int* n_tris, float** normals_out,
                int* n_normals) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return 1;
  std::vector<float> verts, norms;
  std::vector<int> tris, tri_norms;
  bool all_have_normals = true;
  char line[8192];
  while (std::fgets(line, sizeof line, f)) {
    if (line[0] == 'v' && line[1] == ' ') {
      float x, y, z;
      if (std::sscanf(line + 2, "%f %f %f", &x, &y, &z) == 3) {
        verts.push_back(x);
        verts.push_back(y);
        verts.push_back(z);
      }
    } else if (line[0] == 'v' && line[1] == 'n' && line[2] == ' ') {
      float x, y, z;
      if (std::sscanf(line + 3, "%f %f %f", &x, &y, &z) == 3) {
        norms.push_back(x);
        norms.push_back(y);
        norms.push_back(z);
      }
    } else if (line[0] == 'f' && line[1] == ' ') {
      std::vector<Corner> cs;
      char* p = line + 2;
      while (*p) {
        while (*p == ' ' || *p == '\t') ++p;
        if (*p == '\n' || *p == '\r' || *p == '\0') break;
        Corner c{0, 0};
        c.v = (int)std::strtol(p, &p, 10);
        if (*p == '/') {
          ++p;
          if (*p != '/') (void)std::strtol(p, &p, 10);  // texcoord, ignored
          if (*p == '/') {
            ++p;
            c.n = (int)std::strtol(p, &p, 10);
          }
        }
        cs.push_back(c);
        while (*p && *p != ' ' && *p != '\t' && *p != '\n' && *p != '\r') ++p;
      }
      for (size_t k = 1; k + 1 < cs.size(); ++k) {  // fan triangulation
        tris.push_back(cs[0].v);
        tris.push_back(cs[k].v);
        tris.push_back(cs[k + 1].v);
        tri_norms.push_back(cs[0].n);
        tri_norms.push_back(cs[k].n);
        tri_norms.push_back(cs[k + 1].n);
        if (!cs[0].n || !cs[k].n || !cs[k + 1].n) all_have_normals = false;
      }
    }
  }
  std::fclose(f);

  int nv = (int)(verts.size() / 3);
  int nt = (int)(tris.size() / 3);
  int* t = (int*)std::malloc(sizeof(int) * tris.size());
  for (size_t k = 0; k < tris.size(); ++k) t[k] = fixIndex(tris[k], nv);

  bool aligned = all_have_normals && (int)(norms.size() / 3) == nv && nt > 0;
  if (aligned) {
    for (size_t k = 0; k < tri_norms.size() && aligned; ++k)
      if (fixIndex(tri_norms[k], (int)(norms.size() / 3)) != t[k])
        aligned = false;
  }

  float* v = (float*)std::malloc(sizeof(float) * verts.size());
  std::memcpy(v, verts.data(), sizeof(float) * verts.size());
  *verts_out = v;
  *n_verts = nv;
  *tris_out = t;
  *n_tris = nt;
  if (aligned) {
    float* n = (float*)std::malloc(sizeof(float) * norms.size());
    std::memcpy(n, norms.data(), sizeof(float) * norms.size());
    *normals_out = n;
    *n_normals = (int)(norms.size() / 3);
  } else {
    *normals_out = nullptr;
    *n_normals = 0;
  }
  return 0;
}

void rt_free(void* p) { std::free(p); }

}  // extern "C"
