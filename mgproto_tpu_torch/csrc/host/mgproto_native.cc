// Native host-side kernels of the PyTorch port's input pipeline: the port's
// own copy of the JAX package's csrc/mgproto_native.cc, same arithmetic.
//
// The loader overlaps PIL decode on a worker pool; this library removes the
// remaining per-image Python cost: the uint8 HWC -> normalized float32
// conversion, which in numpy is four array passes ((x/255 - mean)/std) per
// image. Here it is one fused pass using three 256-entry per-channel lookup
// tables, and the four colour-jitter ops of the host train pipeline. (The
// JAX package's threaded whole-batch conversion is not copied: neither
// package's loader calls it.)
//
// Exposed via ctypes; see mgproto_tpu_torch/native. Build with
// -ffp-contract=off: an FMA would skip the f32 rounding between the two
// steps of PIL's blend and break bit-exactness.

#include <cstddef>
#include <cstdint>

namespace {

// Build per-channel LUTs: lut[c][v] = v * scale[c] + bias[c].
// With scale = 1/(255*std) and bias = -mean/std this is exactly
// (v/255 - mean)/std up to f32 rounding.
inline void build_luts(const float* scale, const float* bias, float lut[3][256]) {
  for (int c = 0; c < 3; ++c) {
    for (int v = 0; v < 256; ++v) {
      lut[c][v] = static_cast<float>(v) * scale[c] + bias[c];
    }
  }
}

inline void convert_px(const uint8_t* src, int64_t n_px,
                       const float lut[3][256], float* out) {
  for (int64_t i = 0; i < n_px; ++i) {
    const uint8_t* p = src + 3 * i;
    float* q = out + 3 * i;
    q[0] = lut[0][p[0]];
    q[1] = lut[1][p[1]];
    q[2] = lut[2][p[2]];
  }
}

}  // namespace

extern "C" {

// Fused (u8/255 - mean)/std for one [n_px, 3] interleaved HWC image.
// scale[3] = 1/(255*std), bias[3] = -mean/std (precomputed by the caller).
void mg_u8hwc_to_f32_norm(const uint8_t* src, int64_t n_px, const float* scale,
                          const float* bias, float* out) {
  float lut[3][256];
  build_luts(scale, bias, lut);
  convert_px(src, n_px, lut, out);
}

// Plain u8 -> f32 in [0, 1] (the push pipeline is unnormalized,
// reference main.py:111-116).
void mg_u8hwc_to_f32(const uint8_t* src, int64_t n, float* out) {
  float lut[256];
  for (int v = 0; v < 256; ++v) lut[v] = static_cast<float>(v) * (1.0f / 255.0f);
  for (int64_t i = 0; i < n; ++i) out[i] = lut[src[i]];
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Fused color-jitter kernels (train augmentation hot spot).
//
// The train pipeline's ColorJitter (reference main.py:100) is the bulk of
// the per-sample host cost when it runs on the host. Each kernel below is
// ONE pass over the interleaved u8 HWC image and reproduces Pillow's
// arithmetic BIT-EXACTLY (pinned by tests/test_torch_native.py against the
// numpy plain versions):
//
//   * Image.blend on u8:      float math, truncate toward zero, clip [0,255]
//   * convert("L"):           (19595 R + 38470 G + 7471 B + 0x8000) >> 16
//   * ImageStat mean:         double sum / n, then (int)(mean + 0.5)
//   * convert("HSV")/("RGB"): C float variables with double-promoted
//     expressions — written below exactly as Pillow's Convert.c does
//     (double literals force the promotion), which is what makes C the
//     natural home for this op: the numpy emulation needs an astype dance
//     per expression to mimic it, and runs slower than PIL on one core.

namespace {

inline uint8_t clip_trunc(float v) {
  int i = static_cast<int>(v);  // C cast truncates toward zero, like Pillow
  if (i < 0) return 0;
  if (i > 255) return 255;
  return static_cast<uint8_t>(i);
}

inline uint32_t luma_u8(const uint8_t* p) {
  return (19595u * p[0] + 38470u * p[1] + 7471u * p[2] + 0x8000u) >> 16;
}

}  // namespace

extern "C" {

// Brightness: blend(black, img, factor) == factor * img.
void mg_jitter_brightness(const uint8_t* src, int64_t n_px, float factor,
                          uint8_t* out) {
  for (int64_t i = 0; i < 3 * n_px; ++i) {
    out[i] = clip_trunc(factor * static_cast<float>(src[i]));
  }
}

// Contrast: blend(solid gray at round(mean(L)), img, factor).
void mg_jitter_contrast(const uint8_t* src, int64_t n_px, float factor,
                        uint8_t* out) {
  // zero-pixel guard: sum/n_px would be NaN and the float->int cast of NaN
  // is undefined behavior. Nothing to write either way.
  if (n_px <= 0) return;
  double sum = 0.0;  // ImageStat sums the integer L histogram
  for (int64_t i = 0; i < n_px; ++i) sum += luma_u8(src + 3 * i);
  const float gray =
      static_cast<float>(static_cast<int>(sum / static_cast<double>(n_px) + 0.5));
  for (int64_t i = 0; i < 3 * n_px; ++i) {
    out[i] = clip_trunc(gray + factor * (static_cast<float>(src[i]) - gray));
  }
}

// Saturation (ImageEnhance.Color): blend(L replicated to RGB, img, factor).
void mg_jitter_saturation(const uint8_t* src, int64_t n_px, float factor,
                          uint8_t* out) {
  for (int64_t i = 0; i < n_px; ++i) {
    const uint8_t* p = src + 3 * i;
    uint8_t* q = out + 3 * i;
    const float lum = static_cast<float>(luma_u8(p));
    q[0] = clip_trunc(lum + factor * (static_cast<float>(p[0]) - lum));
    q[1] = clip_trunc(lum + factor * (static_cast<float>(p[1]) - lum));
    q[2] = clip_trunc(lum + factor * (static_cast<float>(p[2]) - lum));
  }
}

// Fused RGB -> HSV -> (H + shift, u8 wraparound) -> RGB, one pass.
// Float/double mixing mirrors Pillow's Convert.c exactly (see header note).
// Every floating-point DIVISION is replaced by a lookup whose entries are
// computed with the identical expression (so bit-exactness is preserved by
// construction): divisions were ~2/3 of this kernel's per-pixel cost.
namespace {

struct HueLuts {
  float div[256][256];    // div[cr][d]  = (float)d / (float)cr       (cr>=1)
  uint8_t sat[256][256];  // sat[maxc][cr] = (uint8)(cr * 255.0 / maxc)
  int32_t sector[256];    // sector[hue] = (int)(hue * 6.0 / 255.0)
  float frac[256];        // frac[hue]   = float(fh - sector)
  float fs[256];          // fs[sat]     = (float)(sat / 255.0)
  HueLuts() {
    for (int cr = 1; cr < 256; ++cr) {
      for (int d = 0; d < 256; ++d) {
        div[cr][d] = static_cast<float>(d) / static_cast<float>(cr);
      }
    }
    for (int d = 0; d < 256; ++d) div[0][d] = 0.0f;
    for (int maxc = 1; maxc < 256; ++maxc) {
      for (int cr = 0; cr < 256; ++cr) {
        // cr > maxc never occurs for real pixels; clamp those unused
        // entries so the uint8 cast is never UB
        const double s = cr <= maxc ? cr * 255.0 / maxc : 255.0;
        sat[maxc][cr] = static_cast<uint8_t>(s);
      }
    }
    for (int cr = 0; cr < 256; ++cr) sat[0][cr] = 0;
    // hsv2rgb is PURE float arithmetic in Pillow (verified exhaustively
    // over all 2^24 HSV values): float literals here, not double
    for (int hue = 0; hue < 256; ++hue) {
      const float fh = hue * 6.0f / 255.0f;
      sector[hue] = static_cast<int>(fh);
      frac[hue] = fh - static_cast<float>(sector[hue]);
    }
    for (int s = 0; s < 256; ++s) fs[s] = s / 255.0f;
  }
};

}  // namespace

void mg_hue_shift(const uint8_t* src, int64_t n_px, int32_t shift,
                  uint8_t* out) {
  static const HueLuts lut;  // C++11 thread-safe one-time init
  for (int64_t i = 0; i < n_px; ++i) {
    const uint8_t* p = src + 3 * i;
    uint8_t* q = out + 3 * i;
    const uint8_t r = p[0], g = p[1], b = p[2];
    uint8_t umax = r > g ? r : g;
    if (b > umax) umax = b;
    uint8_t umin = r < g ? r : g;
    if (b < umin) umin = b;
    const int ucr = umax - umin;
    uint8_t hue = 0;
    const uint8_t sat = lut.sat[umax][ucr];
    if (ucr != 0) {
      const float* row = lut.div[ucr];
      const float rc = row[umax - r];
      const float gc = row[umax - g];
      const float bc = row[umax - b];
      float h;
      if (r == umax) {
        h = bc - gc;
      } else if (g == umax) {
        h = 2.0 + rc - bc;
      } else {
        h = 4.0 + gc - rc;
      }
      h = h / 6.0;
      if (h < 0.0f) h = h + 1.0;
      hue = static_cast<uint8_t>(h * 255.0);
    }
    hue = static_cast<uint8_t>(hue + shift);  // u8 wraparound = hue circle
    // hsv2rgb (sector formula; p/q/t round half-up, sector truncates)
    const int v = umax;
    if (sat == 0) {
      q[0] = q[1] = q[2] = static_cast<uint8_t>(v);
      continue;
    }
    const float maxc = umax;
    const int sector = lut.sector[hue];
    const float f = lut.frac[hue];
    const float fs = lut.fs[sat];
    const int pp = static_cast<int>(maxc * (1.0f - fs) + 0.5f);
    const int qq = static_cast<int>(maxc * (1.0f - fs * f) + 0.5f);
    const int tt = static_cast<int>(maxc * (1.0f - fs * (1.0f - f)) + 0.5f);
    switch (sector % 6) {
      case 0: q[0] = v;  q[1] = tt; q[2] = pp; break;
      case 1: q[0] = qq; q[1] = v;  q[2] = pp; break;
      case 2: q[0] = pp; q[1] = v;  q[2] = tt; break;
      case 3: q[0] = pp; q[1] = qq; q[2] = v;  break;
      case 4: q[0] = tt; q[1] = pp; q[2] = v;  break;
      default: q[0] = v; q[1] = pp; q[2] = qq; break;
    }
  }
}

}  // extern "C"
