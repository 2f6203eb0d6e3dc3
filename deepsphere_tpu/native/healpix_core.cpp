// Native host-precompute core for deepsphere_tpu.
//
// The reference delegates its geometry and graph construction to native
// libraries (healpy's C++ HEALPix core, scipy/ARPACK, sklearn's BallTree —
// see SURVEY.md §2.1).  This is this framework's equivalent: a small
// C-ABI library that produces, in one pass, everything the device needs
// for a grid-structured sphere graph at a given nside —
//
//   * the NEST 8-neighbor table,
//   * pixel center unit vectors,
//   * Gaussian edge weights + the symmetric-normalized Laplacian in padded
//     ELLPACK layout (fixed width 9),
//   * lmax via Lanczos on the fixed-degree matvec,
//   * the rescaled-Laplacian face-stencil weight planes (padded-activation
//     coordinates, see graph/stencil.py),
//
// replacing minutes of numpy/scipy time at nside >= 1024 with seconds.
// Exposed through ctypes (deepsphere_tpu/native/__init__.py); the Python
// implementations remain as the portable fallback and as the test oracle.

#include <cstdint>
#include <cmath>
#include <cstring>
#include <vector>

using i64 = int64_t;
using i32 = int32_t;

// ---------------------------------------------------------------------------
// bit interleaving
// ---------------------------------------------------------------------------

static inline i64 spread_bits(i64 v) {
    v &= 0xFFFFFFFFll;
    v = (v | (v << 16)) & 0x0000FFFF0000FFFFll;
    v = (v | (v << 8)) & 0x00FF00FF00FF00FFll;
    v = (v | (v << 4)) & 0x0F0F0F0F0F0F0F0Fll;
    v = (v | (v << 2)) & 0x3333333333333333ll;
    v = (v | (v << 1)) & 0x5555555555555555ll;
    return v;
}

static inline i64 compress_bits(i64 v) {
    v &= 0x5555555555555555ll;
    v = (v | (v >> 1)) & 0x3333333333333333ll;
    v = (v | (v >> 2)) & 0x0F0F0F0F0F0F0F0Fll;
    v = (v | (v >> 4)) & 0x00FF00FF00FF00FFll;
    v = (v | (v >> 8)) & 0x0000FFFF0000FFFFll;
    v = (v | (v >> 16)) & 0x00000000FFFFFFFFll;
    return v;
}

static inline i64 xyf2nest(i64 nside, i64 ix, i64 iy, i64 face, int order) {
    return (face << (2 * order)) + (spread_bits(ix) | (spread_bits(iy) << 1));
}

static inline void nest2xyf(i64 nside, i64 pix, int order,
                            i64* ix, i64* iy, i64* face) {
    *face = pix >> (2 * order);
    i64 within = pix & (nside * nside - 1);
    *ix = compress_bits(within);
    *iy = compress_bits(within >> 1);
}

static inline int ilog2(i64 v) {
    int r = 0;
    while (v > 1) { v >>= 1; ++r; }
    return r;
}

// ---------------------------------------------------------------------------
// face-transition tables (healpix_base neighbor algorithm layout)
// ---------------------------------------------------------------------------

static const i64 NB_XOFFSET[8] = {-1, -1, 0, 1, 1, 1, 0, -1};
static const i64 NB_YOFFSET[8] = {0, 1, 1, 1, 0, -1, -1, -1};
static const i64 NB_FACEARRAY[9][12] = {
    {8, 9, 10, 11, -1, -1, -1, -1, 10, 11, 8, 9},
    {5, 6, 7, 4, 8, 9, 10, 11, 9, 10, 11, 8},
    {-1, -1, -1, -1, 5, 6, 7, 4, -1, -1, -1, -1},
    {4, 5, 6, 7, 11, 8, 9, 10, 11, 8, 9, 10},
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11},
    {1, 2, 3, 0, 0, 1, 2, 3, 5, 6, 7, 4},
    {-1, -1, -1, -1, 7, 4, 5, 6, -1, -1, -1, -1},
    {3, 0, 1, 2, 3, 0, 1, 2, 4, 5, 6, 7},
    {2, 3, 0, 1, -1, -1, -1, -1, 0, 1, 2, 3},
};
static const i64 NB_SWAPARRAY[9][3] = {
    {0, 0, 3}, {0, 0, 6}, {0, 0, 0}, {0, 0, 5}, {0, 0, 0},
    {5, 0, 0}, {0, 0, 0}, {6, 0, 0}, {3, 0, 0},
};

// resolve (possibly out-of-face) coordinates to in-face (xf, yf, nbf);
// returns the global NEST pixel, or -1 if none (missing polar corner).
// valid for overhangs < nside (single face crossing).
static inline i64 coords_resolve(i64 nside, int order, i64 x, i64 y,
                                 i64 face, i64* xf_o, i64* yf_o, i64* f_o) {
    i64 nsm1 = nside - 1;
    int xs = x < 0 ? -1 : (x > nsm1 ? 1 : 0);
    int ys = y < 0 ? -1 : (y > nsm1 ? 1 : 0);
    if (xs == 0 && ys == 0) {
        *xf_o = x; *yf_o = y; *f_o = face;
        return xyf2nest(nside, x, y, face, order);
    }
    i64 nbnum = 4 + xs + 3 * ys;
    i64 nbf = NB_FACEARRAY[nbnum][face];
    if (nbf < 0) return -1;
    i64 bits = NB_SWAPARRAY[nbnum][face >> 2];
    i64 xw = x & nsm1;
    i64 yw = y & nsm1;
    i64 xw2 = (bits & 1) ? nsm1 - xw : xw;
    i64 yw2 = (bits & 2) ? nsm1 - yw : yw;
    i64 xf = (bits & 4) ? yw2 : xw2;
    i64 yf = (bits & 4) ? xw2 : yw2;
    *xf_o = xf; *yf_o = yf; *f_o = nbf;
    return xyf2nest(nside, xf, yf, nbf, order);
}

// global NEST pixel at (possibly out-of-face) coordinates; -1 if none.
static i64 face_coords_to_pix(i64 nside, int order, i64 x, i64 y, i64 face) {
    i64 xf, yf, f;
    return coords_resolve(nside, order, x, y, face, &xf, &yf, &f);
}

// ---------------------------------------------------------------------------
// geometry
// ---------------------------------------------------------------------------

static const i64 JRLL[12] = {2, 2, 2, 2, 3, 3, 3, 3, 4, 4, 4, 4};
static const i64 JPLL[12] = {1, 3, 5, 7, 0, 2, 4, 6, 1, 3, 5, 7};

static inline void xyf2vec(i64 nside, i64 ix, i64 iy, i64 face,
                           double* vx, double* vy, double* vz) {
    const double PI = 3.14159265358979323846;
    i64 npix = 12 * nside * nside;
    i64 nl4 = 4 * nside;
    i64 jr = JRLL[face] * nside - ix - iy - 1;

    bool north = jr < nside;
    bool south = jr > 3 * nside;
    i64 nr = north ? jr : (south ? nl4 - jr : nside);

    double fact2 = 4.0 / (double)npix;
    double fact1 = (double)(nside * 2) * fact2;
    double z = north ? 1.0 - (double)(nr * nr) * fact2
                     : (south ? -1.0 + (double)(nr * nr) * fact2
                              : (double)(2 * nside - jr) * fact1);
    i64 kshift = (north || south) ? 0 : ((jr - nside) & 1);

    i64 jp = (JPLL[face] * nr + ix - iy + 1 + kshift) / 2;
    if (jp > nl4) jp -= nl4;
    if (jp < 1) jp += nl4;

    double phi = ((double)jp - (kshift + 1) * 0.5) * (PI / 2.0) / (double)nr;
    double st = std::sqrt(1.0 - z * z);
    *vx = st * std::cos(phi);
    *vy = st * std::sin(phi);
    *vz = z;
}

extern "C" {

// (npix, 3) pixel center unit vectors, NEST order
void ds_pix2vec_nest(i64 nside, double* out) {
    int order = ilog2(nside);
    i64 npix = 12 * nside * nside;
    for (i64 p = 0; p < npix; ++p) {
        i64 ix, iy, face;
        nest2xyf(nside, p, order, &ix, &iy, &face);
        xyf2vec(nside, ix, iy, face, out + 3 * p, out + 3 * p + 1, out + 3 * p + 2);
    }
}

// (npix, 8) NEST grid neighbors (SW,W,NW,N,NE,E,SE,S), -1 where none
void ds_neighbors_nest(i64 nside, i64* out) {
    int order = ilog2(nside);
    i64 npix = 12 * nside * nside;
    for (i64 p = 0; p < npix; ++p) {
        i64 ix, iy, face;
        nest2xyf(nside, p, order, &ix, &iy, &face);
        if (ix > 0 && ix < nside - 1 && iy > 0 && iy < nside - 1) {
            // interior fast path: all neighbors stay on this face; their
            // NEST ids differ from p only in the interleaved x/y bits
            i64 fb = face << (2 * order);
            i64 xm = spread_bits(ix - 1), x0 = spread_bits(ix), xp = spread_bits(ix + 1);
            i64 ym = spread_bits(iy - 1) << 1, y0 = spread_bits(iy) << 1,
                yp = spread_bits(iy + 1) << 1;
            out[8 * p + 0] = fb + (xm | y0);  // SW (-1, 0)
            out[8 * p + 1] = fb + (xm | yp);  // W  (-1, 1)
            out[8 * p + 2] = fb + (x0 | yp);  // NW (0, 1)
            out[8 * p + 3] = fb + (xp | yp);  // N  (1, 1)
            out[8 * p + 4] = fb + (xp | y0);  // NE (1, 0)
            out[8 * p + 5] = fb + (xp | ym);  // E  (1, -1)
            out[8 * p + 6] = fb + (x0 | ym);  // SE (0, -1)
            out[8 * p + 7] = fb + (xm | ym);  // S  (-1, -1)
            continue;
        }
        for (int d = 0; d < 8; ++d) {
            out[8 * p + d] = face_coords_to_pix(
                nside, order, ix + NB_XOFFSET[d], iy + NB_YOFFSET[d], face);
        }
    }
}

// Grid-graph rescaled Laplacian, one pass.
//
// Outputs (caller-allocated):
//   nb        (npix, 8) i64   neighbor table (-1 padded)
//   w         (npix, 8) f64   Gaussian edge weights (0 where no neighbor)
//   ell_idx   (npix, 9) i32   UNSCALED normalized-Laplacian ELLPACK columns:
//                             slot d in 0..7 = neighbor in direction d
//                             (self-pointing 0 where absent), slot 8 = diag
//   ell_val   (npix, 9) f64   matching Laplacian values (diag = 1)
//   params    [kernel_width_used, lmax]  f64
//
// Callers apply the reference rescale (utils.py:40-46) per scale as
//   val_s = (2 scale / lmax) * val;  val_s[:, 8] -= 1.
// kernel_width == 0 selects the mean neighbor distance; kernel_width < 0
// selects |kernel_width| * mean neighbor distance (ratio mode, used by the
// harmonic width table in graph/laplacian.py).  lmax is estimated
// with up to `lanczos_iters` double-precision Lanczos steps (Ritz-residual
// stop at 1e-10 relative — the <1e-5 parity target needs lmax at machine
// precision) and multiplied by 1.02.
void ds_grid_laplacian(i64 nside, double kernel_width,
                       int lanczos_iters,
                       i64* nb, double* w, i32* ell_idx, double* ell_val,
                       double* params) {
    i64 npix = 12 * nside * nside;
    ds_neighbors_nest(nside, nb);

    std::vector<double> vec(3 * npix);
    ds_pix2vec_nest(nside, vec.data());

    // squared chord distances + mean distance
    std::vector<double> d2(8 * npix, 0.0);
    double dist_sum = 0.0;
    i64 dist_cnt = 0;
    for (i64 p = 0; p < npix; ++p) {
        for (int d = 0; d < 8; ++d) {
            i64 q = nb[8 * p + d];
            if (q < 0) continue;
            double dx = vec[3 * p] - vec[3 * q];
            double dy = vec[3 * p + 1] - vec[3 * q + 1];
            double dz = vec[3 * p + 2] - vec[3 * q + 2];
            double dd = dx * dx + dy * dy + dz * dz;
            d2[8 * p + d] = dd;
            dist_sum += std::sqrt(dd);
            ++dist_cnt;
        }
    }
    double mean_dist = dist_sum / (double)dist_cnt;
    double kw = kernel_width > 0 ? kernel_width
              : kernel_width < 0 ? -kernel_width * mean_dist
                                 : mean_dist;
    params[0] = kw;

    // Gaussian weights + degrees
    std::vector<double> deg(npix, 0.0);
    for (i64 p = 0; p < npix; ++p) {
        for (int d = 0; d < 8; ++d) {
            i64 q = nb[8 * p + d];
            double wv = (q >= 0) ? std::exp(-d2[8 * p + d] / (2.0 * kw * kw)) : 0.0;
            w[8 * p + d] = wv;
            deg[p] += wv;
        }
    }

    // normalized Laplacian entries: diag 1, offdiag -w/sqrt(di dj)
    std::vector<double> dinv(npix);
    for (i64 p = 0; p < npix; ++p)
        dinv[p] = deg[p] > 0 ? 1.0 / std::sqrt(deg[p]) : 0.0;

    // unscaled-Laplacian ELLPACK, direction-aligned slots (f64; it doubles
    // as the Lanczos operator below)
    for (i64 p = 0; p < npix; ++p) {
        double dp = dinv[p];
        for (int d = 0; d < 8; ++d) {
            i64 q = nb[8 * p + d];
            ell_idx[9 * p + d] = (i32)(q >= 0 ? q : p);
            ell_val[9 * p + d] = q >= 0 ? -w[8 * p + d] * dp * dinv[q] : 0.0;
        }
        ell_idx[9 * p + 8] = (i32)p;
        ell_val[9 * p + 8] = 1.0;
    }

    auto matvec = [&](const double* x, double* y) {
        for (i64 p = 0; p < npix; ++p) {
            double acc = x[p];  // unit diagonal
            const i32* cp = ell_idx + 9 * p;
            const double* vp = ell_val + 9 * p;
            for (int d = 0; d < 8; ++d) acc += vp[d] * x[cp[d]];
            y[p] = acc;
        }
    };

    // Plain double-precision Lanczos with a Ritz-residual stopping rule.
    // lmax must land at ~1e-9 relative: a relative error eps in lmax
    // perturbs every rescaled-Laplacian entry by O(eps), which would break
    // the <1e-5 per-layer parity vs the reference (ARPACK at machine
    // precision, gnn_layers.py:66).
    int m = lanczos_iters;
    std::vector<double> v_prev(npix, 0.0), v_cur(npix), v_next(npix);
    std::vector<double> alpha, beta;
    // deterministic start vector
    double nrm0 = 1.0 / std::sqrt((double)npix);
    for (i64 p = 0; p < npix; ++p) v_cur[p] = nrm0 * ((p % 7) - 3.0 + 0.5);
    double nn = 0.0;
    for (i64 p = 0; p < npix; ++p) nn += v_cur[p] * v_cur[p];
    nn = 1.0 / std::sqrt(nn);
    for (i64 p = 0; p < npix; ++p) v_cur[p] *= nn;

    // Top Ritz value of the s x s tridiagonal via Sturm-sequence bisection
    // (robust for the clustered top spectrum of the sphere Laplacian, where
    // power iteration stalls); *slast = last component of its eigenvector
    // (inverse iteration), so |beta_s * slast| bounds the Ritz residual.
    auto top_ritz = [&](int s, double* slast) {
        // eigenvalue count below x by the Sturm recurrence
        auto count_below = [&](double x) {
            int cnt = 0;
            double d = alpha[0] - x;
            if (d < 0) ++cnt;
            for (int r = 1; r < s; ++r) {
                double b2 = beta[r - 1] * beta[r - 1];
                double dd = (d == 0.0) ? 1e-300 : d;
                d = (alpha[r] - x) - b2 / dd;
                if (d < 0) ++cnt;
            }
            return cnt;
        };
        // Gershgorin upper bound
        double hi = alpha[0] + (s > 1 ? std::abs(beta[0]) : 0.0);
        double lo = alpha[0] - (s > 1 ? std::abs(beta[0]) : 0.0);
        for (int r = 1; r < s; ++r) {
            double rad = std::abs(beta[r - 1]) +
                         (r + 1 < s ? std::abs(beta[r]) : 0.0);
            hi = std::max(hi, alpha[r] + rad);
            lo = std::min(lo, alpha[r] - rad);
        }
        for (int it = 0; it < 200 && hi - lo > 1e-14 * std::max(1.0, std::abs(hi)); ++it) {
            double mid = 0.5 * (lo + hi);
            if (count_below(mid) >= s)  // all eigenvalues below mid
                hi = mid;
            else
                lo = mid;
        }
        double lam = 0.5 * (lo + hi);
        // inverse iteration for the eigenvector's last component: solve
        // (T - (lam + eps) I) y = v with the Thomas algorithm, twice
        std::vector<double> y(s, 1.0 / std::sqrt((double)s));
        double shift = lam * (1.0 + 1e-12) + 1e-300;
        for (int pass = 0; pass < 2; ++pass) {
            std::vector<double> c(s), dv(s);
            double dd = alpha[0] - shift;
            if (std::abs(dd) < 1e-14) dd = 1e-14;
            c[0] = (s > 1 ? beta[0] : 0.0) / dd;
            dv[0] = y[0] / dd;
            for (int r = 1; r < s; ++r) {
                double m = (alpha[r] - shift) - beta[r - 1] * c[r - 1];
                if (std::abs(m) < 1e-14) m = 1e-14;
                c[r] = (r + 1 < s ? beta[r] : 0.0) / m;
                dv[r] = (y[r] - beta[r - 1] * dv[r - 1]) / m;
            }
            y[s - 1] = dv[s - 1];
            for (int r = s - 2; r >= 0; --r) y[r] = dv[r] - c[r] * y[r + 1];
            double nrm = 0.0;
            for (int r = 0; r < s; ++r) nrm += y[r] * y[r];
            nrm = 1.0 / std::sqrt(nrm);
            for (int r = 0; r < s; ++r) y[r] *= nrm;
        }
        *slast = y[s - 1];
        return lam;
    };

    double lmax = 0.0;
    for (int j = 0; j < m; ++j) {
        matvec(v_cur.data(), v_next.data());
        double a = 0.0;
        for (i64 p = 0; p < npix; ++p) a += v_cur[p] * v_next[p];
        alpha.push_back(a);
        double bprev = j > 0 ? beta[j - 1] : 0.0;
        for (i64 p = 0; p < npix; ++p)
            v_next[p] -= a * v_cur[p] + bprev * v_prev[p];
        double b = 0.0;
        for (i64 p = 0; p < npix; ++p) b += v_next[p] * v_next[p];
        b = std::sqrt(b);
        int s = j + 1;
        if (b < 1e-12 || s % 8 == 0 || j == m - 1) {
            double slast;
            double lam = top_ritz(s, &slast);
            lmax = lam;
            if (b < 1e-12 || b * std::abs(slast) < 1e-10 * lam) break;
        }
        beta.push_back(b);
        double binv = 1.0 / b;
        for (i64 p = 0; p < npix; ++p) {
            v_prev[p] = v_cur[p];
            v_cur[p] = v_next[p] * binv;
        }
    }
    lmax *= 1.02;  // reference safety margin (gnn_layers.py:66)
    params[1] = lmax;
}

// Stencil weight planes of a rescaled grid Laplacian, in padded-activation
// coordinates (see graph/stencil.py): out has shape (9, 12, P_r, P_l) with
// P_r = nside + round_up(2 n_steps, 8), P_l = round_up(nside + 2 n_steps,
// 128); entry [d, f, x + n_steps, y + n_steps] weighs face coord (x, y).
// Directions 0..7 follow NB offsets; 8 is the center.  Requires the
// neighbor table and the rescaled ELLPACK from ds_grid_laplacian.
void ds_stencil_weights(i64 nside, i64 n_steps,
                        const i32* ell_idx, const float* ell_val,
                        float* out) {
    int order = ilog2(nside);
    i64 h = n_steps - 1;  // weight coverage depth
    i64 P_r = nside + ((2 * n_steps + 7) / 8) * 8;
    i64 P_l = ((nside + 2 * n_steps + 127) / 128) * 128;
    std::memset(out, 0, sizeof(float) * 9 * 12 * P_r * P_l);

    auto lookup = [&](i64 row, i64 colq) -> float {
        const i32* ir = ell_idx + 9 * row;
        const float* vr = ell_val + 9 * row;
        float acc = 0.0f;
        for (int t = 0; t < 9; ++t)
            if (ir[t] == (i32)colq) acc += vr[t];
        return acc;
    };

    for (i64 f = 0; f < 12; ++f) {
        for (i64 x = -h; x < nside + h; ++x) {
            for (i64 y = -h; y < nside + h; ++y) {
                i64 p = face_coords_to_pix(nside, order, x, y, f);
                if (p < 0) continue;
                i64 base_r = x + n_steps;
                i64 base_c = y + n_steps;
                float* cell = out + ((0 * 12 + f) * P_r + base_r) * P_l + base_c;
                i64 plane = 12 * P_r * P_l;
                for (int d = 0; d < 8; ++d) {
                    i64 q = face_coords_to_pix(
                        nside, order, x + NB_XOFFSET[d], y + NB_YOFFSET[d], f);
                    if (q < 0) continue;
                    cell[d * plane] = lookup(p, q);
                }
                cell[8 * plane] = lookup(p, p);
            }
        }
    }
}

// Gaussian smoothing-template ELLPACK (nn/smoothing.py::_template_ellpack
// numpy oracle, ported for the nside>=512 cold-start path — the reference's
// equivalent is the BallTree kernel build at healpy_layers.py:766-799).
//
// Row-normalized fixed-width operator of ONE narrow-template repetition of
// the stencil decomposition: taps are the (2r+1)^2-1 raster offsets (center
// last), weights exp(-ang^2 / 2 sig^2) truncated at n_sigma_support * sig,
// masked rows/edges zeroed (idx self-pointing where invalid).
//
// Outputs (caller-allocated):
//   ell_idx (npix, T+1) i32, ell_val (npix, T+1) f64, T = (2r+1)^2 - 1
void ds_gauss_template(i64 nside, i64 radius, double sig,
                       double n_sigma_support, const uint8_t* in_mask,
                       i32* ell_idx, double* ell_val) {
    int order = ilog2(nside);
    i64 r = radius;
    i64 side = 2 * r + 1;
    i64 T = side * side - 1;
    i64 Wd = T + 1;

    double amax = n_sigma_support * sig;
    double inv2s2 = 0.5 / (sig * sig);
    // chord^2 pre-filter with safety margin: taps clearly past the support
    // skip asin/exp; borderline taps still take the exact ang <= amax test
    double c2pre = 5.0;  // amax >= pi: every tap is inside the support
    if (amax < 3.14159265358979323846) {
        double cmax = 2.0 * std::sin(0.5 * amax);
        c2pre = cmax * cmax * (1.0 + 1e-9) + 1e-300;
    }

    // Morton-quad blocking: within a face, NEST ids ARE Morton(x, y), so a
    // Morton-aligned B x B quad occupies a contiguous B^2 id range.  Walking
    // quads in Morton order and pixels within a quad in Morton order makes
    // the (npix, T+1) output writes strictly sequential (no NEST-scatter TLB
    // storm — the dominant cost of the naive loop), while each pixel's unit
    // vector is computed once into an L1-resident (B+2r)^2 patch.
    i64 B = 32;
    while (B > nside) B >>= 1;
    i64 PW = B + 2 * r;  // patch width
    i64 nquads = (nside / B) * (nside / B);
    std::vector<double> bx(PW * PW), by(PW * PW), bz(PW * PW);
    std::vector<i64> bq(PW * PW);
    std::vector<uint8_t> bm(PW * PW);

    for (i64 f = 0; f < 12; ++f) {
        for (i64 qm = 0; qm < nquads; ++qm) {
            i64 X = compress_bits(qm) * B;
            i64 Y = compress_bits(qm >> 1) * B;
            for (i64 lx = -r; lx < B + r; ++lx) {
                i64 row = (lx + r) * PW;
                for (i64 ly = -r; ly < B + r; ++ly) {
                    i64 j = row + ly + r;
                    i64 xf, yf, ff;
                    i64 q = coords_resolve(nside, order, X + lx, Y + ly, f,
                                           &xf, &yf, &ff);
                    bq[j] = q;
                    if (q >= 0) {
                        xyf2vec(nside, xf, yf, ff, &bx[j], &by[j], &bz[j]);
                        bm[j] = in_mask[q];
                    } else {
                        bm[j] = 0;
                    }
                }
            }
            for (i64 m = 0; m < B * B; ++m) {  // Morton: p is sequential
                i64 lx = compress_bits(m);
                i64 ly = compress_bits(m >> 1);
                i64 jc = (lx + r) * PW + ly + r;
                i64 p = bq[jc];
                const double px = bx[jc], py = by[jc], pz = bz[jc];
                bool prow = bm[jc] != 0;
                i32* ir = ell_idx + Wd * p;
                double* vr = ell_val + Wd * p;
                double rowsum = 0.0;
                i64 t = 0;
                for (i64 dx = -r; dx <= r; ++dx) {
                    i64 base = (lx + dx + r) * PW + ly + r;
                    for (i64 dy = -r; dy <= r; ++dy) {
                        if (dx == 0 && dy == 0) continue;
                        i64 j = base + dy;
                        i64 q = bq[j];
                        double w = 0.0;
                        i64 col = p;
                        if (q >= 0 && prow && bm[j]) {
                            col = q;
                            double ddx = px - bx[j];
                            double ddy = py - by[j];
                            double ddz = pz - bz[j];
                            double c2 = ddx * ddx + ddy * ddy + ddz * ddz;
                            if (c2 <= c2pre) {
                                if (c2 < 0.0) c2 = 0.0;
                                if (c2 > 4.0) c2 = 4.0;
                                double ang =
                                    2.0 * std::asin(std::sqrt(c2) * 0.5);
                                if (ang <= amax)
                                    w = std::exp(-ang * ang * inv2s2);
                            }
                        }
                        ir[t] = (i32)col;
                        vr[t] = w;
                        rowsum += w;
                        ++t;
                    }
                }
                double center = prow ? 1.0 : 0.0;
                rowsum += center;
                if (rowsum == 0.0) rowsum = 1.0;
                double inv = 1.0 / rowsum;
                for (i64 tt = 0; tt < T; ++tt) vr[tt] *= inv;
                ir[T] = (i32)p;
                vr[T] = center * inv;
            }
        }
    }
}

// Generic radius-r stencil weight-plane extraction from a full-sphere
// ELLPACK (the graph/stencil.py::_lookup_entries loop, ported).  Planes
// follow stencil_offsets(radius): raster order minus center, center LAST.
//
// out has the wide-embedded layout of graph/stencil.py::face_stencil's
// w_emb: (nplanes, 12, P_r, P_l) with P_r = nside + roundup(2 n_steps, 8),
// P_l = roundup(nside + 2 n_steps, 128); entry [d, f, x + n_steps,
// y + n_steps] weighs face coord (x, y) for x, y in [-(n_steps - radius),
// nside + n_steps - radius).  captured (12 * Pw * Pw f64, Pw = nside +
// 2 (n_steps - radius)) returns sum_d |w| per position for the caller's
// mass-conservation check.
//
// raster_ordered = 1 asserts the ELLPACK columns of every full-interior
// row are exactly the raster taps in plane order (true for the smoothing
// template builder above); those rows then copy without search.
void ds_ellpack_stencil_planes(i64 nside, i64 n_steps, i64 radius, i64 W,
                               int raster_ordered,
                               const i32* ell_idx, const double* ell_val,
                               float* out, double* captured) {
    int order = ilog2(nside);
    i64 h = n_steps - radius;
    i64 Pw = nside + 2 * h;
    i64 P_r = nside + ((2 * n_steps + 7) / 8) * 8;
    i64 P_l = ((nside + 2 * n_steps + 127) / 128) * 128;
    i64 nplanes = (2 * radius + 1) * (2 * radius + 1);
    i64 plane = 12 * P_r * P_l;

    // plane order must match graph/stencil.py::stencil_offsets: radius 1
    // keeps the legacy healpix_base neighbor order, radius > 1 is raster
    std::vector<i64> odx(nplanes), ody(nplanes);
    if (radius == 1) {
        for (i64 t = 0; t < 8; ++t) { odx[t] = NB_XOFFSET[t]; ody[t] = NB_YOFFSET[t]; }
        odx[8] = 0; ody[8] = 0;
    } else {
        i64 t = 0;
        for (i64 dx = -radius; dx <= radius; ++dx)
            for (i64 dy = -radius; dy <= radius; ++dy)
                if (dx != 0 || dy != 0) { odx[t] = dx; ody[t] = dy; ++t; }
        odx[t] = 0; ody[t] = 0;  // center last
    }

    auto lookup = [&](i64 row, i64 colq) -> double {
        const i32* ir = ell_idx + W * row;
        const double* vr = ell_val + W * row;
        double acc = 0.0;
        for (i64 t = 0; t < W; ++t)
            if (ir[t] == (i32)colq) acc += vr[t];
        return acc;
    };

    // the raster fast path requires plane order == ELLPACK tap order,
    // which only holds for the raster plane enumeration (radius > 1)
    bool fast_ok = raster_ordered && W == nplanes && radius > 1;
    for (i64 f = 0; f < 12; ++f) {
        for (i64 x = -h; x < nside + h; ++x) {
            for (i64 y = -h; y < nside + h; ++y) {
                i64 pos = (f * Pw + (x + h)) * Pw + (y + h);
                i64 p = face_coords_to_pix(nside, order, x, y, f);
                if (p < 0) { captured[pos] = 0.0; continue; }
                float* cell =
                    out + (f * P_r + (x + n_steps)) * P_l + (y + n_steps);
                double cap = 0.0;
                if (fast_ok && x >= radius && x < nside - radius &&
                    y >= radius && y < nside - radius) {
                    // full-interior row: columns ARE the raster taps
                    const double* vr = ell_val + W * p;
                    for (i64 d = 0; d < nplanes; ++d) {
                        double v = vr[d];
                        cell[d * plane] = (float)v;
                        cap += std::abs(v);
                    }
                } else {
                    for (i64 d = 0; d < nplanes; ++d) {
                        i64 q = face_coords_to_pix(nside, order, x + odx[d],
                                                   y + ody[d], f);
                        if (q < 0) continue;
                        double v = lookup(p, q);
                        cell[d * plane] = (float)v;
                        cap += std::abs(v);
                    }
                }
                captured[pos] = cap;
            }
        }
    }
}

}  // extern "C"
