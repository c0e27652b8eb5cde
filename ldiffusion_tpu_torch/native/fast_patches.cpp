// Host batch patch extraction and spatial augmentation for the segmentor's
// input pipeline: the port's own copy of ldiffusion_tpu/native/fast_patches.cpp
// (crop_with_pad_batch, affine_augment_batch, affine_augment_batch_3d), with
// the same C interface and the same arithmetic, so both libraries give the
// same bits.
//
// crop_with_pad_batch: crop + pad (0 for data, -1 for labels) of B patches,
// multithreaded over the batch. Layout: data float32 (*spatial, C)
// C-contiguous, seg int16 (*spatial); nd = 2 (H, W) or 3 (D, H, W).
//
// Build: g++ -O3 -shared -fPIC -std=c++17 -pthread fast_patches.cpp
//        (ldiffusion_tpu_torch/native/__init__.py builds it at first use).

#include <cstdint>
#include <cmath>
#include <cstring>
#include <algorithm>
#include <thread>
#include <vector>

namespace {

struct Item {
    const float* data;
    const int16_t* seg;
    const int64_t* shape;   // nd spatial dims
    const int64_t* lb;      // nd lower-bound coords (may be negative)
};

// Copy one patch (crop + pad) for a 2D case.
void copy_2d(const Item& it, int64_t ph, int64_t pw, int64_t C,
             float* out_data, int16_t* out_seg) {
    const int64_t H = it.shape[0], W = it.shape[1];
    const int64_t y0 = it.lb[0], x0 = it.lb[1];
    const int64_t sy0 = std::max<int64_t>(0, y0), sy1 = std::min(H, y0 + ph);
    const int64_t sx0 = std::max<int64_t>(0, x0), sx1 = std::min(W, x0 + pw);
    // fully-covered patches (the common case) need no pad clear — every
    // output element is overwritten below
    const bool covered = (sy0 == y0 && sx0 == x0 &&
                          sy1 == y0 + ph && sx1 == x0 + pw);
    if (!covered) {
        std::memset(out_data, 0, sizeof(float) * ph * pw * C);
        std::fill(out_seg, out_seg + ph * pw, (int16_t)-1);
    }
    if (sy1 <= sy0 || sx1 <= sx0) return;
    const int64_t row_elems = (sx1 - sx0) * C;
    for (int64_t y = sy0; y < sy1; ++y) {
        const int64_t oy = y - y0, ox = sx0 - x0;
        std::memcpy(out_data + (oy * pw + ox) * C,
                    it.data + (y * W + sx0) * C, sizeof(float) * row_elems);
        std::memcpy(out_seg + oy * pw + ox,
                    it.seg + y * W + sx0, sizeof(int16_t) * (sx1 - sx0));
    }
}

// Copy one patch (crop + pad) for a 3D case: the 2D row copies, for each z.
void copy_3d(const Item& it, int64_t pd, int64_t ph, int64_t pw, int64_t C,
             float* out_data, int16_t* out_seg) {
    const int64_t D = it.shape[0], H = it.shape[1], W = it.shape[2];
    const int64_t z0 = it.lb[0], y0 = it.lb[1], x0 = it.lb[2];
    const int64_t sz0 = std::max<int64_t>(0, z0), sz1 = std::min(D, z0 + pd);
    const int64_t sy0 = std::max<int64_t>(0, y0), sy1 = std::min(H, y0 + ph);
    const int64_t sx0 = std::max<int64_t>(0, x0), sx1 = std::min(W, x0 + pw);
    const bool covered = (sz0 == z0 && sy0 == y0 && sx0 == x0 &&
                          sz1 == z0 + pd && sy1 == y0 + ph && sx1 == x0 + pw);
    if (!covered) {
        std::memset(out_data, 0, sizeof(float) * pd * ph * pw * C);
        std::fill(out_seg, out_seg + pd * ph * pw, (int16_t)-1);
    }
    if (sz1 <= sz0 || sy1 <= sy0 || sx1 <= sx0) return;
    const int64_t row_elems = (sx1 - sx0) * C;
    for (int64_t z = sz0; z < sz1; ++z) {
        const int64_t oz = z - z0;
        for (int64_t y = sy0; y < sy1; ++y) {
            const int64_t oy = y - y0, ox = sx0 - x0;
            std::memcpy(out_data + ((oz * ph + oy) * pw + ox) * C,
                        it.data + ((z * H + y) * W + sx0) * C,
                        sizeof(float) * row_elems);
            std::memcpy(out_seg + (oz * ph + oy) * pw + ox,
                        it.seg + (z * H + y) * W + sx0,
                        sizeof(int16_t) * (sx1 - sx0));
        }
    }
}

// Run work(b0, b1) over [0, B) on at most n_threads threads.
template <typename F>
void parallel_batches(int64_t B, int64_t n_threads, F work) {
    const int64_t nt = std::max<int64_t>(1, std::min(n_threads, B));
    if (nt == 1) {
        work(0, B);
        return;
    }
    std::vector<std::thread> threads;
    const int64_t per = (B + nt - 1) / nt;
    for (int64_t t = 0; t < nt; ++t) {
        const int64_t b0 = t * per, b1 = std::min(B, b0 + per);
        if (b0 >= b1) break;
        threads.emplace_back(work, b0, b1);
    }
    for (auto& th : threads) th.join();
}

}  // namespace

extern "C" {

// datas/segs: B pointers to case arrays; shapes: (B, nd) spatial dims;
// lbs: (B, nd) patch lower bounds; patch: (nd) patch size; C channels.
// out_data: (B, *patch, C) float32; out_seg: (B, *patch) int16.
void crop_with_pad_batch(const float** datas, const int16_t** segs,
                         const int64_t* shapes, const int64_t* lbs,
                         int64_t B, int64_t nd, const int64_t* patch,
                         int64_t C, float* out_data, int16_t* out_seg,
                         int64_t n_threads) {
    int64_t patch_vox = 1;
    for (int64_t a = 0; a < nd; ++a) patch_vox *= patch[a];
    const int64_t data_stride = patch_vox * C;

    auto work = [&](int64_t b0, int64_t b1) {
        for (int64_t b = b0; b < b1; ++b) {
            Item it{datas[b], segs[b], shapes + b * nd, lbs + b * nd};
            if (nd == 2) {
                copy_2d(it, patch[0], patch[1], C,
                        out_data + b * data_stride, out_seg + b * patch_vox);
            } else {
                copy_3d(it, patch[0], patch[1], patch[2], C,
                        out_data + b * data_stride, out_seg + b * patch_vox);
            }
        }
    };
    parallel_batches(B, n_threads, work);
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Host-side spatial augmentation (rotation+scale), the batchgenerators
// SpatialTransform analog (reference nnUNetTrainer.py:673-795 runs it in CPU
// worker processes). It runs in the trainer's prefetch thread, overlapping
// the device's step.
//
// Math: the inverse map about the patch center of
// ldiffusion_tpu/data/augment.py:_affine_coords, bilinear (zero outside)
// for data, nearest (zero outside) for seg.

extern "C" {

// data_order: 1 = bilinear (default), 0 = nearest (the nnUNetTrainerDAOrd0
// variant's order_resampling_data=0).
// OH/OW: output (center-crop) size, <= H/W. The transform is still taken
// about the INPUT patch center; only the centered OHxOW window of the
// virtual HxW output grid is computed — the initial-patch enlargement
// (data/augment.py:configure_spatial_da) otherwise interpolates 1.4-4x
// more pixels than the model consumes.
void affine_augment_batch(const float** datas, const int16_t** segs,
                          int64_t B, int64_t H, int64_t W, int64_t C,
                          int64_t OH, int64_t OW,
                          const double* angles, const double* scales,
                          const uint8_t* apply,
                          float* out_data, int16_t* out_seg,
                          int64_t n_threads, int64_t data_order) {
    const int64_t img_elems = OH * OW * C;
    const int64_t seg_elems = OH * OW;
    const int64_t offy = (H - OH) / 2, offx = (W - OW) / 2;

    auto work = [&](int64_t b0, int64_t b1) {
        for (int64_t b = b0; b < b1; ++b) {
            const float* din = datas[b];
            const int16_t* sin_ = segs[b];
            float* dout = out_data + b * img_elems;
            int16_t* sout = out_seg + b * seg_elems;
            if (!apply[b]) {
                // identity transform -> plain center crop
                for (int64_t i = 0; i < OH; ++i) {
                    std::memcpy(dout + i * OW * C,
                                din + ((i + offy) * W + offx) * C,
                                sizeof(float) * OW * C);
                    std::memcpy(sout + i * OW,
                                sin_ + (i + offy) * W + offx,
                                sizeof(int16_t) * OW);
                }
                continue;
            }
            const double cy = (H - 1) / 2.0, cx = (W - 1) / 2.0;
            const double cosv = std::cos(angles[b]), sinv = std::sin(angles[b]);
            const double inv_s = 1.0 / scales[b];
            for (int64_t i = 0; i < OH; ++i) {
                const double y = i + offy - cy;
                for (int64_t j = 0; j < OW; ++j) {
                    const double x = j + offx - cx;
                    const double sy = (cosv * y + sinv * x) * inv_s + cy;
                    const double sx = (-sinv * y + cosv * x) * inv_s + cx;
                    float* po = dout + (i * OW + j) * C;
                    const int64_t ry = (int64_t)std::llround(sy);
                    const int64_t rx = (int64_t)std::llround(sx);
                    if (data_order == 0) {
                        // nearest, zero outside
                        const bool in = (ry >= 0 && ry < H && rx >= 0 && rx < W);
                        for (int64_t c = 0; c < C; ++c)
                            po[c] = in ? din[(ry * W + rx) * C + c] : 0.0f;
                    } else {
                        // bilinear, zero outside
                        const int64_t y0 = (int64_t)std::floor(sy);
                        const int64_t x0 = (int64_t)std::floor(sx);
                        const double fy = sy - y0, fx = sx - x0;
                        const double w00 = (1 - fy) * (1 - fx), w01 = (1 - fy) * fx;
                        const double w10 = fy * (1 - fx), w11 = fy * fx;
                        for (int64_t c = 0; c < C; ++c) {
                            double acc = 0.0;
                            if (y0 >= 0 && y0 < H) {
                                if (x0 >= 0 && x0 < W)
                                    acc += w00 * din[(y0 * W + x0) * C + c];
                                if (x0 + 1 >= 0 && x0 + 1 < W)
                                    acc += w01 * din[(y0 * W + x0 + 1) * C + c];
                            }
                            if (y0 + 1 >= 0 && y0 + 1 < H) {
                                if (x0 >= 0 && x0 < W)
                                    acc += w10 * din[((y0 + 1) * W + x0) * C + c];
                                if (x0 + 1 >= 0 && x0 + 1 < W)
                                    acc += w11 * din[((y0 + 1) * W + x0 + 1) * C + c];
                            }
                            po[c] = (float)acc;
                        }
                    }
                    // nearest for labels, zero outside
                    sout[i * OW + j] =
                        (ry >= 0 && ry < H && rx >= 0 && rx < W)
                            ? sin_[ry * W + rx] : (int16_t)0;
                }
            }
        }
    };

    parallel_batches(B, n_threads, work);
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Host 3D spatial augmentation: Euler rotation R = Rx·Ry·Rz and an isotropic
// scale about the volume centre, the batchgenerators 3D SpatialTransform
// analog (reference nnUNetTrainer.py:673-795). The inverse map R^T / scale;
// trilinear (zero outside) or nearest data, nearest labels (zero outside:
// outside trains as background, as in 2D). Axes (z, y, x) are the matrix's
// rows (0, 1, 2).

extern "C" {

// OD/OH/OW: the centred output window, <= D/H/W (see the 2D comment).
void affine_augment_batch_3d(const float** datas, const int16_t** segs,
                             int64_t B, int64_t D, int64_t H, int64_t W, int64_t C,
                             int64_t OD, int64_t OH, int64_t OW,
                             const double* angles_x, const double* angles_y,
                             const double* angles_z, const double* scales,
                             const uint8_t* apply,
                             float* out_data, int16_t* out_seg,
                             int64_t n_threads, int64_t data_order) {
    const int64_t img_elems = OD * OH * OW * C;
    const int64_t seg_elems = OD * OH * OW;
    const int64_t offz = (D - OD) / 2, offy = (H - OH) / 2, offx = (W - OW) / 2;

    auto work = [&](int64_t b0, int64_t b1) {
        for (int64_t b = b0; b < b1; ++b) {
            const float* din = datas[b];
            const int16_t* sin_ = segs[b];
            float* dout = out_data + b * img_elems;
            int16_t* sout = out_seg + b * seg_elems;
            if (!apply[b]) {
                // identity transform -> plain centre crop
                for (int64_t k = 0; k < OD; ++k)
                    for (int64_t i = 0; i < OH; ++i) {
                        const int64_t src = ((k + offz) * H + (i + offy)) * W + offx;
                        std::memcpy(dout + ((k * OH + i) * OW) * C, din + src * C,
                                    sizeof(float) * OW * C);
                        std::memcpy(sout + (k * OH + i) * OW, sin_ + src,
                                    sizeof(int16_t) * OW);
                    }
                continue;
            }
            const double cz = (D - 1) / 2.0, cy = (H - 1) / 2.0, cx = (W - 1) / 2.0;
            const double cxr = std::cos(angles_x[b]), sxr = std::sin(angles_x[b]);
            const double cyr = std::cos(angles_y[b]), syr = std::sin(angles_y[b]);
            const double czr = std::cos(angles_z[b]), szr = std::sin(angles_z[b]);
            const double r00 = cyr * czr, r01 = -cyr * szr, r02 = syr;
            const double r10 = cxr * szr + sxr * syr * czr;
            const double r11 = cxr * czr - sxr * syr * szr;
            const double r12 = -sxr * cyr;
            const double r20 = sxr * szr - cxr * syr * czr;
            const double r21 = sxr * czr + cxr * syr * szr;
            const double r22 = cxr * cyr;
            const double inv_s = 1.0 / scales[b];
            for (int64_t k = 0; k < OD; ++k) {
                const double z = k + offz - cz;
                for (int64_t i = 0; i < OH; ++i) {
                    const double y = i + offy - cy;
                    for (int64_t j = 0; j < OW; ++j) {
                        const double x = j + offx - cx;
                        const double sz = (r00 * z + r10 * y + r20 * x) * inv_s + cz;
                        const double sy = (r01 * z + r11 * y + r21 * x) * inv_s + cy;
                        const double sx = (r02 * z + r12 * y + r22 * x) * inv_s + cx;
                        float* po = dout + ((k * OH + i) * OW + j) * C;
                        const int64_t rz = (int64_t)std::llround(sz);
                        const int64_t ry = (int64_t)std::llround(sy);
                        const int64_t rx = (int64_t)std::llround(sx);
                        const bool rin = (rz >= 0 && rz < D && ry >= 0 && ry < H &&
                                          rx >= 0 && rx < W);
                        if (data_order == 0) {
                            for (int64_t c = 0; c < C; ++c)
                                po[c] = rin ? din[((rz * H + ry) * W + rx) * C + c] : 0.0f;
                        } else {
                            const int64_t z0 = (int64_t)std::floor(sz);
                            const int64_t y0 = (int64_t)std::floor(sy);
                            const int64_t x0 = (int64_t)std::floor(sx);
                            const double fz = sz - z0, fy = sy - y0, fx = sx - x0;
                            for (int64_t c = 0; c < C; ++c) {
                                double acc = 0.0;
                                for (int dz = 0; dz < 2; ++dz) {
                                    const int64_t zz = z0 + dz;
                                    if (zz < 0 || zz >= D) continue;
                                    const double wz = dz ? fz : 1.0 - fz;
                                    for (int dy = 0; dy < 2; ++dy) {
                                        const int64_t yy = y0 + dy;
                                        if (yy < 0 || yy >= H) continue;
                                        const double wy = dy ? fy : 1.0 - fy;
                                        for (int dx = 0; dx < 2; ++dx) {
                                            const int64_t xx = x0 + dx;
                                            if (xx < 0 || xx >= W) continue;
                                            acc += wz * wy * (dx ? fx : 1.0 - fx) *
                                                   din[((zz * H + yy) * W + xx) * C + c];
                                        }
                                    }
                                }
                                po[c] = (float)acc;
                            }
                        }
                        sout[(k * OH + i) * OW + j] =
                            rin ? sin_[(rz * H + ry) * W + rx] : (int16_t)0;
                    }
                }
            }
        }
    };
    parallel_batches(B, n_threads, work);
}

}  // extern "C"
