// yoloq_host: native host-side runtime for yoloq.
//
// The accelerator runs the network; these are the per-frame host paths that the
// reference implements in C (src/box.c NMS, src/image.c resize, the
// examples/detector.c:842-854 F1 matching loop) and that dominate host CPU
// time in serving/eval:
//   - greedy class-agnostic NMS (do_nms_obj semantics, src/box.c:21-55)
//   - per-class NMS (do_nms_sort semantics, src/box.c:58-88)
//   - truth<->detection IoU matching for F1/recall counting
//   - darknet align-corners bilinear resize (src/image.c resize_image)
//
// Exposed as a plain C ABI consumed via ctypes (yoloq/utils/native.py).
// Build: make -C native   (produces libyoloq_host.so)

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <numeric>
#include <vector>

extern "C" {

// Boxes are center-format (x, y, w, h), row-major (m, 4).
static inline float overlap(float x1, float w1, float x2, float w2) {
  float l1 = x1 - w1 / 2, l2 = x2 - w2 / 2;
  float left = l1 > l2 ? l1 : l2;
  float r1 = x1 + w1 / 2, r2 = x2 + w2 / 2;
  float right = r1 < r2 ? r1 : r2;
  return right - left;
}

static inline float box_iou(const float* a, const float* b) {
  float w = overlap(a[0], a[2], b[0], b[2]);
  float h = overlap(a[1], a[3], b[1], b[3]);
  if (w <= 0 || h <= 0) return 0.f;
  float inter = w * h;
  float uni = a[2] * a[3] + b[2] * b[3] - inter;
  return uni > 0 ? inter / uni : 0.f;
}

// Class-agnostic greedy NMS, darknet do_nms_obj semantics: sort by objectness
// descending, zero the objectness (and class probs when given) of any lower
// box overlapping a surviving box; suppressed entries stay in the arrays.
// cls may be null. Returns number of surviving (non-zero) boxes.
int yq_nms_obj(float* boxes, float* obj, float* cls, int m, int classes,
               float thresh) {
  std::vector<int> order(m);
  std::iota(order.begin(), order.end(), 0);
  std::stable_sort(order.begin(), order.end(),
                   [&](int a, int b) { return obj[a] > obj[b]; });
  int alive = 0;
  for (int oi = 0; oi < m; ++oi) {
    int i = order[oi];
    if (obj[i] == 0) continue;
    ++alive;
    for (int oj = oi + 1; oj < m; ++oj) {
      int j = order[oj];
      if (obj[j] == 0) continue;
      if (box_iou(boxes + 4 * i, boxes + 4 * j) > thresh) {
        obj[j] = 0;
        if (cls) std::memset(cls + classes * j, 0, sizeof(float) * classes);
      }
    }
  }
  return alive;
}

// Per-class greedy NMS, darknet do_nms_sort semantics on probs (m, classes):
// for each class, sort by prob descending and zero overlapping lower probs.
void yq_nms_sort(const float* boxes, float* probs, int m, int classes,
                 float thresh) {
  std::vector<int> order(m);
  for (int c = 0; c < classes; ++c) {
    std::iota(order.begin(), order.end(), 0);
    std::stable_sort(order.begin(), order.end(), [&](int a, int b) {
      return probs[a * classes + c] > probs[b * classes + c];
    });
    for (int oi = 0; oi < m; ++oi) {
      int i = order[oi];
      if (probs[i * classes + c] == 0) continue;
      for (int oj = oi + 1; oj < m; ++oj) {
        int j = order[oj];
        if (probs[j * classes + c] == 0) continue;
        if (box_iou(boxes + 4 * i, boxes + 4 * j) > thresh)
          probs[j * classes + c] = 0;
      }
    }
  }
}

// F1 matching inner loop (examples/detector.c:842-854): for each truth box,
// find the best IoU among detections with objectness > thresh.  Returns TP
// count (best_iou > iou_thresh); *iou_sum accumulates the best IoUs.
int yq_match_truths(const float* det_boxes, const float* det_obj, int m,
                    const float* truth_boxes, int t, float thresh,
                    float iou_thresh, float* iou_sum) {
  int tp = 0;
  float acc = 0.f;
  for (int j = 0; j < t; ++j) {
    float best = 0.f;
    for (int k = 0; k < m; ++k) {
      if (det_obj[k] <= thresh) continue;
      float iou = box_iou(det_boxes + 4 * k, truth_boxes + 4 * j);
      if (iou > best) best = iou;
    }
    acc += best;
    if (best > iou_thresh) ++tp;
  }
  if (iou_sum) *iou_sum += acc;
  return tp;
}

// darknet align-corners bilinear resize (src/image.c resize_image):
// HWC float32, sample x = c * (src-1)/(dst-1).  Column pass then row pass.
void yq_resize_bilinear(const float* src, int sh, int sw, float* dst, int dh,
                        int dw, int ch) {
  std::vector<float> part((size_t)sh * dw * ch);
  float wscale = dw > 1 ? (float)(sw - 1) / (dw - 1) : 0.f;
  float hscale = dh > 1 ? (float)(sh - 1) / (dh - 1) : 0.f;
  for (int r = 0; r < sh; ++r) {
    for (int c = 0; c < dw; ++c) {
      float x = c * wscale;
      int ix = (int)x;
      if (ix > sw - 2) ix = sw - 2 < 0 ? 0 : sw - 2;
      float dx = x - ix;
      int ix1 = sw > 1 ? ix + 1 : ix;
      for (int k = 0; k < ch; ++k) {
        part[((size_t)r * dw + c) * ch + k] =
            (1 - dx) * src[((size_t)r * sw + ix) * ch + k] +
            dx * src[((size_t)r * sw + ix1) * ch + k];
      }
    }
  }
  for (int r = 0; r < dh; ++r) {
    float y = r * hscale;
    int iy = (int)y;
    if (iy > sh - 2) iy = sh - 2 < 0 ? 0 : sh - 2;
    float dy = y - iy;
    int iy1 = sh > 1 ? iy + 1 : iy;
    for (int c = 0; c < dw; ++c) {
      for (int k = 0; k < ch; ++k) {
        dst[((size_t)r * dw + c) * ch + k] =
            (1 - dy) * part[((size_t)iy * dw + c) * ch + k] +
            dy * part[((size_t)iy1 * dw + c) * ch + k];
      }
    }
  }
}

// Letterbox: resize preserving aspect onto a 0.5-gray dh x dw canvas
// (src/image.c:812-831).
void yq_letterbox(const float* src, int sh, int sw, float* dst, int dh, int dw,
                  int ch) {
  int nw, nh;
  if ((float)dw / sw < (float)dh / sh) {
    nw = dw;
    nh = (sh * dw) / sw;
  } else {
    nh = dh;
    nw = (sw * dh) / sh;
  }
  std::vector<float> resized((size_t)nh * nw * ch);
  yq_resize_bilinear(src, sh, sw, resized.data(), nh, nw, ch);
  for (size_t i = 0; i < (size_t)dh * dw * ch; ++i) dst[i] = 0.5f;
  int oy = (dh - nh) / 2, ox = (dw - nw) / 2;
  for (int r = 0; r < nh; ++r)
    std::memcpy(dst + (((size_t)(r + oy)) * dw + ox) * ch,
                resized.data() + (size_t)r * nw * ch, sizeof(float) * nw * ch);
}

int yq_version() { return 1; }

}  // extern "C"
