// Radiance RGBE codec for utils/image.py.
//
// The port's copy of native/rgbe.cpp, statement for statement, so .hdr files
// hold the JAX package's bytes. Semantics follow the classic Ward RGBE
// encoding used by stb_image's HDR reader/writer (the reference's IO path,
// Image.cpp:49-74); utils/image.py's numpy codec is its plain version.
#include <cmath>
#include <cstddef>
#include <cstdint>

extern "C" {

// rgb: npix*3 float32, out: npix*4 uint8 (R,G,B,E)
void rgbe_encode(const float* rgb, uint8_t* out, size_t npix) {
  for (size_t i = 0; i < npix; ++i) {
    float r = rgb[i * 3 + 0];
    float g = rgb[i * 3 + 1];
    float b = rgb[i * 3 + 2];
    r = r < 0.f ? 0.f : r;
    g = g < 0.f ? 0.f : g;
    b = b < 0.f ? 0.f : b;
    float maxc = r > g ? (r > b ? r : b) : (g > b ? g : b);
    if (maxc < 1e-32f) {
      out[i * 4 + 0] = out[i * 4 + 1] = out[i * 4 + 2] = out[i * 4 + 3] = 0;
      continue;
    }
    int e;
    float m = std::frexp(maxc, &e);  // maxc = m * 2^e, m in [0.5, 1)
    float scale = m * 256.0f / maxc;
    float er = r * scale, eg = g * scale, eb = b * scale;
    out[i * 4 + 0] = static_cast<uint8_t>(er > 255.f ? 255.f : er);
    out[i * 4 + 1] = static_cast<uint8_t>(eg > 255.f ? 255.f : eg);
    out[i * 4 + 2] = static_cast<uint8_t>(eb > 255.f ? 255.f : eb);
    out[i * 4 + 3] = static_cast<uint8_t>(e + 128);
  }
}

// rgbe: npix*4 uint8, out: npix*3 float32
void rgbe_decode(const uint8_t* rgbe, float* out, size_t npix) {
  for (size_t i = 0; i < npix; ++i) {
    int e = rgbe[i * 4 + 3];
    if (e == 0) {
      out[i * 3 + 0] = out[i * 3 + 1] = out[i * 3 + 2] = 0.f;
      continue;
    }
    float scale = std::ldexp(1.0f, e - 136);  // (e-128) - 8 mantissa bits
    out[i * 3 + 0] = (rgbe[i * 4 + 0] + 0.5f) * scale;
    out[i * 3 + 1] = (rgbe[i * 4 + 1] + 0.5f) * scale;
    out[i * 3 + 2] = (rgbe[i * 4 + 2] + 0.5f) * scale;
  }
}

}  // extern "C"
