// Native RLE codec — C++ replacement for the COCO C maskApi used by the
// reference through the lua coco API (SURVEY.md §2.2 "COCO mask/eval ops").
// Hot host-side paths: proposal-mask decode (DeepMask .npz/.json ingestion),
// RLE string codec, area/bbox from runs, mask<->counts.
//
// ABI: plain C functions over flat buffers; built with g++ and loaded via
// ctypes by multipathnet_tpu_torch/data/rle_native.py (the port's copy of
// native/rle.cpp, held byte-equal in results to it and to the NumPy codec
// by tests/test_torch_rle_native.py). Masks are COLUMN-MAJOR flat uint8
// (COCO convention); the Python wrapper handles order. The NumPy versions
// in multipathnet_tpu_torch/data/rle.py are the oracle.

#include <cstdint>
#include <cstring>
#include <algorithm>

extern "C" {

// Decode COCO compressed RLE string -> counts. Returns count of runs,
// or -1 if out_cap is too small / input malformed.
int64_t rle_decode_string(const char* s, int64_t s_len,
                          int64_t* out, int64_t out_cap) {
    int64_t n = 0;
    int64_t i = 0;
    while (i < s_len) {
        int64_t x = 0;
        int k = 0;
        bool more = true;
        while (more) {
            if (i >= s_len) return -1;  // truncated varint
            int64_t v = (int64_t)s[i] - 48;
            x |= (v & 0x1f) << (5 * k);
            more = (v & 0x20) != 0;
            i++;
            k++;
            if (!more && (v & 0x10)) x |= ~int64_t(0) << (5 * k);
        }
        if (n > 2) x += out[n - 2];
        if (n >= out_cap) return -1;
        out[n++] = x;
    }
    return n;
}

// Encode counts -> COCO compressed RLE string. Returns string length,
// or -1 if out_cap too small.
int64_t rle_encode_string(const int64_t* counts, int64_t n,
                          char* out, int64_t out_cap) {
    int64_t len = 0;
    for (int64_t i = 0; i < n; i++) {
        int64_t x = counts[i];
        if (i > 2) x -= counts[i - 2];
        bool more = true;
        while (more) {
            int64_t v = x & 0x1f;
            x >>= 5;  // arithmetic shift (sign-propagating)
            more = !((x == 0 && !(v & 0x10)) || (x == -1 && (v & 0x10)));
            if (more) v |= 0x20;
            if (len >= out_cap) return -1;
            out[len++] = (char)(v + 48);
        }
    }
    return len;
}

// counts -> column-major flat mask (h*w uint8). Returns 0, or -1 if the runs
// do not cover exactly h*w pixels.
int64_t rle_counts_to_mask(const int64_t* counts, int64_t n,
                           uint8_t* mask, int64_t hw) {
    int64_t pos = 0;
    uint8_t val = 0;
    for (int64_t i = 0; i < n; i++) {
        int64_t c = counts[i];
        if (c < 0 || pos + c > hw) return -1;
        if (val) memset(mask + pos, 1, (size_t)c);
        else memset(mask + pos, 0, (size_t)c);
        pos += c;
        val ^= 1;
    }
    return pos == hw ? 0 : -1;
}

// column-major flat mask -> counts. Returns number of runs, -1 if cap hit.
int64_t rle_mask_to_counts(const uint8_t* mask, int64_t hw,
                           int64_t* out, int64_t out_cap) {
    int64_t n = 0;
    uint8_t cur = 0;
    int64_t run = 0;
    for (int64_t i = 0; i < hw; i++) {
        uint8_t v = mask[i] ? 1 : 0;
        if (v == cur) {
            run++;
        } else {
            if (n >= out_cap) return -1;
            out[n++] = run;
            cur = v;
            run = 1;
        }
    }
    if (n >= out_cap) return -1;
    out[n++] = run;
    return n;
}

// area + tight bbox (x, y, w, h) from counts without materializing the mask.
// out5 = {area, x, y, w, h}. Empty mask -> all zeros.
void rle_area_bbox(const int64_t* counts, int64_t n, int64_t h,
                   double* out5) {
    int64_t area = 0;
    int64_t x0 = INT64_MAX, x1 = -1, y0 = INT64_MAX, y1 = -1;
    bool row_full = false;
    int64_t pos = 0;
    for (int64_t i = 0; i < n; i++) {
        int64_t c = counts[i];
        if (i & 1) {  // foreground run [pos, pos+c)
            if (c > 0) {
                area += c;
                int64_t s = pos, e = pos + c - 1;
                int64_t cs = s / h, ce = e / h;
                x0 = std::min(x0, cs);
                x1 = std::max(x1, ce);
                if (ce > cs) {
                    row_full = true;  // run wraps a column: covers all rows
                } else {
                    y0 = std::min(y0, s % h);
                    y1 = std::max(y1, e % h);
                }
            }
        }
        pos += c;
    }
    if (area == 0) {
        out5[0] = out5[1] = out5[2] = out5[3] = out5[4] = 0.0;
        return;
    }
    if (row_full) { y0 = 0; y1 = h - 1; }
    out5[0] = (double)area;
    out5[1] = (double)x0;
    out5[2] = (double)y0;
    out5[3] = (double)(x1 - x0 + 1);
    out5[4] = (double)(y1 - y0 + 1);
}

// Pairwise box IoU (xywh) with crowd semantics — the maskApi bbIou analog,
// used by the evaluator's hot loop. dt (D,4), gt (G,4), iscrowd (G,), out (D*G).
void bb_iou(const double* dt, int64_t d, const double* gt, int64_t g,
            const uint8_t* iscrowd, double* out) {
    for (int64_t j = 0; j < g; j++) {
        double gx1 = gt[j * 4], gy1 = gt[j * 4 + 1];
        double gx2 = gx1 + gt[j * 4 + 2], gy2 = gy1 + gt[j * 4 + 3];
        double ga = gt[j * 4 + 2] * gt[j * 4 + 3];
        for (int64_t i = 0; i < d; i++) {
            double dx1 = dt[i * 4], dy1 = dt[i * 4 + 1];
            double dx2 = dx1 + dt[i * 4 + 2], dy2 = dy1 + dt[i * 4 + 3];
            double da = dt[i * 4 + 2] * dt[i * 4 + 3];
            double iw = std::min(dx2, gx2) - std::max(dx1, gx1);
            double ih = std::min(dy2, gy2) - std::max(dy1, gy1);
            double inter = (iw > 0 && ih > 0) ? iw * ih : 0.0;
            double uni = iscrowd[j] ? da : da + ga - inter;
            out[i * g + j] = uni > 0 ? inter / uni : 0.0;
        }
    }
}

}  // extern "C"
