// Native CPU kernels: reference-semantics sparse tensor contractions and
// the RK4 trajectory loop.
//
// These reproduce the exact arithmetic order of the reference
// implementation's Numba kernels (ref qgs/functions/sparse_mul.py:14-158,
// qgs/integrators/integrate.py:183-223): a scalar accumulation over the COO
// entries in storage order, and y <- y + dt * (b @ k) stage updates.  They
// serve as (a) the honest native single-core baseline for bench.py (the
// reference's Numba is not installed in this image) and (b) the fast exact
// oracle for the trajectory-fidelity tests.
//
// Build: g++ -O3 -march=native -shared -fPIC -o libqgs_kernels.so qgs_kernels.cpp
// Loaded through ctypes (see native.py).

#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// res_i += sum_e val[e] * xx[j_e] * xx[k_e]   (rank-3, vector output)
void sparse_mul3(const int64_t *coords, const double *val, int64_t nnz,
                 const double *xx, double *res, int64_t n1) {
    std::memset(res, 0, sizeof(double) * n1);
    for (int64_t e = 0; e < nnz; ++e) {
        res[coords[3 * e]] += val[e] * xx[coords[3 * e + 1]] * xx[coords[3 * e + 2]];
    }
}

// mat_{ij} += sum_k T_{ijk} xx_k   (rank-3, Jacobian matrix output)
void sparse_mul2(const int64_t *coords, const double *val, int64_t nnz,
                 const double *xx, double *res, int64_t n1) {
    std::memset(res, 0, sizeof(double) * n1 * n1);
    for (int64_t e = 0; e < nnz; ++e) {
        res[coords[3 * e] * n1 + coords[3 * e + 1]] +=
            val[e] * xx[coords[3 * e + 2]];
    }
}

// rank-5 analogues
void sparse_mul5(const int64_t *coords, const double *val, int64_t nnz,
                 const double *xx, double *res, int64_t n1) {
    std::memset(res, 0, sizeof(double) * n1);
    for (int64_t e = 0; e < nnz; ++e) {
        const int64_t *c = coords + 5 * e;
        res[c[0]] += val[e] * xx[c[1]] * xx[c[2]] * xx[c[3]] * xx[c[4]];
    }
}

void sparse_mul4(const int64_t *coords, const double *val, int64_t nnz,
                 const double *xx, double *res, int64_t n1) {
    std::memset(res, 0, sizeof(double) * n1 * n1);
    for (int64_t e = 0; e < nnz; ++e) {
        const int64_t *c = coords + 5 * e;
        res[c[0] * n1 + c[1]] += val[e] * xx[c[2]] * xx[c[3]] * xx[c[4]];
    }
}

// RK4 trajectory loop for the rank-3 tendency tensor with the dummy-1
// state convention: advances `y` (ndim = n1 - 1 real variables) by
// n_steps steps of size dt in place, recording every write_steps-th state
// into `recorded` (if write_steps > 0; layout (n_records, ndim)).
// Returns the number of records written.
int64_t rk4_integrate3(const int64_t *coords, const double *val, int64_t nnz,
                       double *y, int64_t ndim, double dt, int64_t n_steps,
                       int64_t write_steps, double *recorded) {
    const int64_t n1 = ndim + 1;
    std::vector<double> xx(n1), k1(ndim), k2(ndim), k3(ndim), k4(ndim),
        ys(ndim), f(n1);
    int64_t iw = 0;

    auto tendency = [&](const double *state, double *out) {
        xx[0] = 1.0;
        std::memcpy(xx.data() + 1, state, sizeof(double) * ndim);
        sparse_mul3(coords, val, nnz, xx.data(), f.data(), n1);
        std::memcpy(out, f.data() + 1, sizeof(double) * ndim);
    };

    for (int64_t step = 0; step < n_steps; ++step) {
        if (write_steps > 0 && step % write_steps == 0) {
            std::memcpy(recorded + iw * ndim, y, sizeof(double) * ndim);
            ++iw;
        }
        tendency(y, k1.data());
        for (int64_t i = 0; i < ndim; ++i) ys[i] = y[i] + dt * 0.5 * k1[i];
        tendency(ys.data(), k2.data());
        for (int64_t i = 0; i < ndim; ++i) ys[i] = y[i] + dt * 0.5 * k2[i];
        tendency(ys.data(), k3.data());
        for (int64_t i = 0; i < ndim; ++i) ys[i] = y[i] + dt * k3[i];
        tendency(ys.data(), k4.data());
        for (int64_t i = 0; i < ndim; ++i)
            y[i] += dt * (k1[i] / 6.0 + k2[i] / 3.0 + k3[i] / 3.0 + k4[i] / 6.0);
    }
    if (write_steps > 0) {
        std::memcpy(recorded + iw * ndim, y, sizeof(double) * ndim);
        ++iw;
    }
    return iw;
}

}  // extern "C"
