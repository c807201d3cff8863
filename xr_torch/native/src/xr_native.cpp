// xr_torch native host components (C++), behind a plain C ABI and loaded
// from Python with ctypes (xr_torch/native/api.py builds this file with g++
// into build/xr_torch/native/ on first use).
//
// Host-side asset work only; every frame is rendered by torch and the CUDA
// kernels:
//
//   * OBJ parsing (v/vt/vn/f with index deduplication, fan triangulation,
//     usemtl material ranges, negative indices)
//   * PNG encoding (8-bit RGB, zlib deflate): frame dumps at frame rate
//   * the box-filter mip chain of one texture (the flattened
//     TexturePyramid layout of xr_torch/core/types.py)
//
// The pure-Python paths (xr_torch/scene/objio.py, xr_torch/core/image.py,
// xr_torch/scene/texture.py) give the same arrays and bytes; the tests hold
// the two against each other.

#include <zlib.h>

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cstdlib>
#include <string>
#include <unordered_map>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// OBJ parsing
// ---------------------------------------------------------------------------

struct XrObjMesh {
  float* positions;  // (V, 3)
  float* normals;    // (V, 3)
  float* uvs;        // (V, 2)
  int32_t* indices;  // (T, 3)
  int32_t* face_mat; // (T,)
  int64_t num_vertices;
  int64_t num_tris;
  int32_t num_materials;
  char* mat_names;   // '\n'-joined material names, in index order
  char* error;       // non-null on failure
};

namespace {

struct Key {
  int v, t, n;
  bool operator==(const Key& o) const { return v == o.v && t == o.t && n == o.n; }
};
struct KeyHash {
  size_t operator()(const Key& k) const {
    return ((size_t)k.v * 73856093u) ^ ((size_t)k.t * 19349663u) ^
           ((size_t)k.n * 83492791u);
  }
};

XrObjMesh* fail(const char* msg) {
  auto* m = (XrObjMesh*)calloc(1, sizeof(XrObjMesh));
  m->error = strdup(msg);
  return m;
}

inline int fix_index(long idx, size_t count) {
  // OBJ indices are 1-based; negative counts from the end.
  if (idx > 0) return (int)(idx - 1);
  if (idx < 0) return (int)((long)count + idx);
  return -1;
}

}  // namespace

XrObjMesh* xr_obj_parse_file(const char* path) {
  FILE* f = fopen(path, "rb");
  if (!f) return fail("cannot open file");

  std::vector<float> vs, vts, vns;        // raw streams
  std::vector<float> out_pos, out_uv, out_nrm;
  std::vector<int32_t> out_idx, out_mat;
  std::unordered_map<Key, int32_t, KeyHash> dedup;
  std::unordered_map<std::string, int32_t> mat_ids;
  std::vector<std::string> mat_order;
  int32_t cur_mat = 0;

  auto get_vertex = [&](const Key& k) -> int32_t {
    auto it = dedup.find(k);
    if (it != dedup.end()) return it->second;
    int32_t id = (int32_t)(out_pos.size() / 3);
    dedup.emplace(k, id);
    if (k.v >= 0 && (size_t)(k.v * 3 + 2) < vs.size()) {
      out_pos.push_back(vs[k.v * 3]);
      out_pos.push_back(vs[k.v * 3 + 1]);
      out_pos.push_back(vs[k.v * 3 + 2]);
    } else {
      out_pos.insert(out_pos.end(), {0.f, 0.f, 0.f});
    }
    if (k.t >= 0 && (size_t)(k.t * 2 + 1) < vts.size()) {
      out_uv.push_back(vts[k.t * 2]);
      out_uv.push_back(vts[k.t * 2 + 1]);
    } else {
      out_uv.insert(out_uv.end(), {0.f, 0.f});
    }
    if (k.n >= 0 && (size_t)(k.n * 3 + 2) < vns.size()) {
      out_nrm.push_back(vns[k.n * 3]);
      out_nrm.push_back(vns[k.n * 3 + 1]);
      out_nrm.push_back(vns[k.n * 3 + 2]);
    } else {
      out_nrm.insert(out_nrm.end(), {0.f, 0.f, 1.f});
    }
    return id;
  };

  char line[4096];
  std::vector<int32_t> face;  // corner vertex ids for the current face
  while (fgets(line, sizeof(line), f)) {
    char* s = line;
    while (*s == ' ' || *s == '\t') s++;
    if (s[0] == 'v' && s[1] == ' ') {
      float x = 0, y = 0, z = 0;
      sscanf(s + 2, "%f %f %f", &x, &y, &z);
      vs.insert(vs.end(), {x, y, z});
    } else if (s[0] == 'v' && s[1] == 't' && s[2] == ' ') {
      float u = 0, v = 0;
      sscanf(s + 3, "%f %f", &u, &v);
      vts.insert(vts.end(), {u, v});
    } else if (s[0] == 'v' && s[1] == 'n' && s[2] == ' ') {
      float x = 0, y = 0, z = 0;
      sscanf(s + 3, "%f %f %f", &x, &y, &z);
      vns.insert(vns.end(), {x, y, z});
    } else if (s[0] == 'f' && (s[1] == ' ' || s[1] == '\t')) {
      face.clear();
      char* p = s + 1;
      while (*p) {
        while (*p == ' ' || *p == '\t') p++;
        if (*p == '\0' || *p == '\n' || *p == '\r' || *p == '#') break;
        char* tok = p;
        long vi = strtol(p, &p, 10);
        if (p == tok) {  // non-numeric token: skip it (strtol won't advance)
          while (*p && *p != ' ' && *p != '\t' && *p != '\n' && *p != '\r')
            p++;
          continue;
        }
        long ti = 0, ni = 0;
        bool has_t = false, has_n = false;
        if (*p == '/') {
          p++;
          if (*p != '/') { ti = strtol(p, &p, 10); has_t = true; }
          if (*p == '/') { p++; ni = strtol(p, &p, 10); has_n = true; }
        }
        Key k{fix_index(vi, vs.size() / 3),
              has_t ? fix_index(ti, vts.size() / 2) : -1,
              has_n ? fix_index(ni, vns.size() / 3) : -1};
        face.push_back(get_vertex(k));
      }
      // fan triangulation
      for (size_t i = 2; i < face.size(); i++) {
        out_idx.push_back(face[0]);
        out_idx.push_back(face[i - 1]);
        out_idx.push_back(face[i]);
        out_mat.push_back(cur_mat);
      }
    } else if (!strncmp(s, "usemtl", 6)) {
      std::string name(s + 6);
      // trim
      size_t a = name.find_first_not_of(" \t\r\n");
      size_t b = name.find_last_not_of(" \t\r\n");
      name = (a == std::string::npos) ? "" : name.substr(a, b - a + 1);
      auto it = mat_ids.find(name);
      if (it == mat_ids.end()) {
        cur_mat = (int32_t)mat_order.size();
        mat_ids.emplace(name, cur_mat);
        mat_order.push_back(name);
      } else {
        cur_mat = it->second;
      }
    }
  }
  fclose(f);

  if (mat_order.empty()) mat_order.push_back("default");

  auto* m = (XrObjMesh*)calloc(1, sizeof(XrObjMesh));
  m->num_vertices = (int64_t)(out_pos.size() / 3);
  m->num_tris = (int64_t)(out_idx.size() / 3);
  m->num_materials = (int32_t)mat_order.size();
  auto dup = [](const auto& v) {
    using T = typename std::decay_t<decltype(v)>::value_type;
    T* p = (T*)malloc(v.size() * sizeof(T) + 1);
    memcpy(p, v.data(), v.size() * sizeof(T));
    return p;
  };
  m->positions = dup(out_pos);
  m->normals = dup(out_nrm);
  m->uvs = dup(out_uv);
  m->indices = dup(out_idx);
  m->face_mat = dup(out_mat);
  std::string names;
  for (size_t i = 0; i < mat_order.size(); i++) {
    if (i) names += '\n';
    names += mat_order[i];
  }
  m->mat_names = strdup(names.c_str());
  return m;
}

void xr_obj_free(XrObjMesh* m) {
  if (!m) return;
  free(m->positions);
  free(m->normals);
  free(m->uvs);
  free(m->indices);
  free(m->face_mat);
  free(m->mat_names);
  free(m->error);
  free(m);
}

// ---------------------------------------------------------------------------
// PNG encode (8-bit RGB, filter 0, one IDAT)
// ---------------------------------------------------------------------------

namespace {
void put_be32(std::vector<uint8_t>& b, uint32_t v) {
  b.push_back((v >> 24) & 0xff);
  b.push_back((v >> 16) & 0xff);
  b.push_back((v >> 8) & 0xff);
  b.push_back(v & 0xff);
}
void chunk(std::vector<uint8_t>& out, const char* tag,
           const uint8_t* data, size_t len) {
  put_be32(out, (uint32_t)len);
  size_t start = out.size();
  out.insert(out.end(), tag, tag + 4);
  out.insert(out.end(), data, data + len);
  uLong crc = crc32(0, out.data() + start, (uInt)(len + 4));
  put_be32(out, (uint32_t)crc);
}
}  // namespace

int xr_write_png(const char* path, const uint8_t* rgb, int64_t h, int64_t w) {
  std::vector<uint8_t> raw((size_t)h * (w * 3 + 1));
  for (int64_t y = 0; y < h; y++) {
    uint8_t* row = raw.data() + (size_t)y * (w * 3 + 1);
    row[0] = 0;  // filter: None
    memcpy(row + 1, rgb + (size_t)y * w * 3, (size_t)w * 3);
  }
  uLongf clen = compressBound((uLong)raw.size());
  std::vector<uint8_t> comp(clen);
  if (compress2(comp.data(), &clen, raw.data(), (uLong)raw.size(), 6) != Z_OK)
    return -1;

  std::vector<uint8_t> out;
  static const uint8_t sig[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1a, '\n'};
  out.insert(out.end(), sig, sig + 8);
  uint8_t ihdr[13];
  ihdr[0] = (uint8_t)((w >> 24) & 0xff); ihdr[1] = (uint8_t)((w >> 16) & 0xff);
  ihdr[2] = (uint8_t)((w >> 8) & 0xff);  ihdr[3] = (uint8_t)(w & 0xff);
  ihdr[4] = (uint8_t)((h >> 24) & 0xff); ihdr[5] = (uint8_t)((h >> 16) & 0xff);
  ihdr[6] = (uint8_t)((h >> 8) & 0xff);  ihdr[7] = (uint8_t)(h & 0xff);
  ihdr[8] = 8;   // bit depth
  ihdr[9] = 2;   // RGB
  ihdr[10] = ihdr[11] = ihdr[12] = 0;
  chunk(out, "IHDR", ihdr, 13);
  chunk(out, "IDAT", comp.data(), clen);
  chunk(out, "IEND", nullptr, 0);

  FILE* f = fopen(path, "wb");
  if (!f) return -2;
  size_t n = fwrite(out.data(), 1, out.size(), f);
  fclose(f);
  return n == out.size() ? 0 : -3;
}

// ---------------------------------------------------------------------------
// Box-filter mip chain (flattened TexturePyramid layout)
// ---------------------------------------------------------------------------

// img: (size, size, 3) f32; out: (sum over levels of (size>>k)^2, 3) f32.
// Level k+1 texel = 0.25 * sum of its 4 level-k parents, matching
// xr_torch/scene/texture.py's `0.25 * (a + b + c + d)` float32 op order.
void xr_build_mips(const float* img, int32_t size, float* out) {
  size_t off = 0;
  memcpy(out, img, (size_t)size * size * 3 * sizeof(float));
  const float* prev = out;
  int s = size;
  while (s > 1) {
    float* dst = out + (off + (size_t)s * s) * 3;
    int hs = s / 2;
    for (int y = 0; y < hs; y++) {
      for (int x = 0; x < hs; x++) {
        for (int c = 0; c < 3; c++) {
          float a = prev[((2 * y) * s + 2 * x) * 3 + c];
          float b = prev[((2 * y) * s + 2 * x + 1) * 3 + c];
          float d = prev[((2 * y + 1) * s + 2 * x) * 3 + c];
          float e = prev[((2 * y + 1) * s + 2 * x + 1) * 3 + c];
          // match texture.py: 0.25f * (a + b + d + e) with f32 adds
          dst[(y * hs + x) * 3 + c] = 0.25f * (((a + b) + d) + e);
        }
      }
    }
    off += (size_t)s * s;
    prev = dst;
    s = hs;
  }
}

}  // extern "C"
