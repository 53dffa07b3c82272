// raytpu native runtime: fast host-side IO.
//
// The reference implements its loaders/IO in C++ (LoadSTL.cpp's
// line-by-line parser, SDL's BMP writer); raytpu keeps the same split:
// the TPU compute path is JAX/Pallas, and the host runtime around it is
// native. This library provides a single-pass ASCII STL parser (~50x the
// python loader on the 9k-triangle reference model) and a BMP codec,
// exposed as a C ABI for ctypes (no pybind11 in the image).
//
// Reference semantics preserved: only "outer loop" facets matter and the
// three following "vertex x y z" lines are read; facet normals in the
// file are ignored (`rasteriser/Source/LoadSTL.cpp:32-61`).

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

extern "C" {

// Parse an ASCII STL. Writes up to max_tris * 9 floats (v0 v1 v2 per
// triangle) into out. Returns the number of triangles in the file (even
// if > max_tris; caller can re-call with a bigger buffer), or -1 on I/O
// error, -2 on parse error.
int raytpu_parse_stl(const char* path, float* out, int max_tris) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;

  int n_tris = 0;
  char line[1024];
  while (fgets(line, sizeof(line), f)) {
    if (!strstr(line, "outer")) continue;
    float tri[9];
    for (int v = 0; v < 3; ++v) {
      if (!fgets(line, sizeof(line), f)) { fclose(f); return -2; }
      const char* p = strstr(line, "vertex");
      if (!p) { fclose(f); return -2; }
      p += 6;
      char* end = nullptr;
      for (int c = 0; c < 3; ++c) {
        tri[v * 3 + c] = strtof(p, &end);
        if (end == p) { fclose(f); return -2; }
        p = end;
      }
    }
    if (n_tris < max_tris) {
      memcpy(out + n_tris * 9, tri, sizeof(tri));
    }
    ++n_tris;
  }
  fclose(f);
  return n_tris;
}

// Write a 24-bpp bottom-up BMP from an (h, w, 3) row-major RGB buffer.
// Returns 0 on success, -1 on I/O error.
int raytpu_write_bmp(const char* path, const uint8_t* rgb, int w, int h) {
  const int row_size = (3 * w + 3) & ~3;
  const int pixel_bytes = row_size * h;
  const int file_size = 14 + 40 + pixel_bytes;

  FILE* f = fopen(path, "wb");
  if (!f) return -1;

  uint8_t header[54] = {0};
  header[0] = 'B'; header[1] = 'M';
  *reinterpret_cast<uint32_t*>(header + 2) = file_size;
  *reinterpret_cast<uint32_t*>(header + 10) = 54;
  *reinterpret_cast<uint32_t*>(header + 14) = 40;
  *reinterpret_cast<int32_t*>(header + 18) = w;
  *reinterpret_cast<int32_t*>(header + 22) = h;
  *reinterpret_cast<uint16_t*>(header + 26) = 1;
  *reinterpret_cast<uint16_t*>(header + 28) = 24;
  *reinterpret_cast<uint32_t*>(header + 34) = pixel_bytes;
  *reinterpret_cast<uint32_t*>(header + 38) = 2835;
  *reinterpret_cast<uint32_t*>(header + 42) = 2835;
  if (fwrite(header, 1, 54, f) != 54) { fclose(f); return -1; }

  std::vector<uint8_t> row(row_size, 0);
  for (int y = h - 1; y >= 0; --y) {
    const uint8_t* src = rgb + static_cast<size_t>(y) * w * 3;
    for (int x = 0; x < w; ++x) {  // RGB -> BGR
      row[x * 3 + 0] = src[x * 3 + 2];
      row[x * 3 + 1] = src[x * 3 + 1];
      row[x * 3 + 2] = src[x * 3 + 0];
    }
    if (fwrite(row.data(), 1, row_size, f) != static_cast<size_t>(row_size)) {
      fclose(f);
      return -1;
    }
  }
  fclose(f);
  return 0;
}

// Read an uncompressed 24/32-bpp BMP. out must hold w*h*3 bytes
// (call with out=null to query dimensions via *w_out/*h_out).
// Returns 0 on success, -1 I/O, -2 unsupported format, -3 buffer too
// small (w/h still written).
int raytpu_read_bmp(const char* path, uint8_t* out, int out_cap,
                    int* w_out, int* h_out) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  uint8_t header[54];
  if (fread(header, 1, 54, f) != 54 || header[0] != 'B' ||
      header[1] != 'M') {
    fclose(f);
    return -2;
  }
  const uint32_t pixel_offset = *reinterpret_cast<uint32_t*>(header + 10);
  const int32_t w = *reinterpret_cast<int32_t*>(header + 18);
  int32_t h = *reinterpret_cast<int32_t*>(header + 22);
  const uint16_t bpp = *reinterpret_cast<uint16_t*>(header + 28);
  const uint32_t compression = *reinterpret_cast<uint32_t*>(header + 30);
  const bool flip = h > 0;
  if (h < 0) h = -h;
  *w_out = w;
  *h_out = h;
  if ((bpp != 24 && bpp != 32) || (compression != 0 && compression != 3)) {
    fclose(f);
    return -2;
  }
  if (!out || out_cap < w * h * 3) { fclose(f); return -3; }

  const int src_row = bpp == 24 ? ((3 * w + 3) & ~3) : 4 * w;
  std::vector<uint8_t> row(src_row);
  fseek(f, pixel_offset, SEEK_SET);
  for (int i = 0; i < h; ++i) {
    if (fread(row.data(), 1, src_row, f) != static_cast<size_t>(src_row)) {
      fclose(f);
      return -1;
    }
    const int y = flip ? (h - 1 - i) : i;
    uint8_t* dst = out + static_cast<size_t>(y) * w * 3;
    const int stride = bpp == 24 ? 3 : 4;
    for (int x = 0; x < w; ++x) {  // BGR(A) -> RGB
      dst[x * 3 + 0] = row[x * stride + 2];
      dst[x * 3 + 1] = row[x * stride + 1];
      dst[x * 3 + 2] = row[x * stride + 0];
    }
  }
  fclose(f);
  return 0;
}

}  // extern "C"
