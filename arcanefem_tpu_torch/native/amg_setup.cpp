// The port's copy of native/amg_setup.cpp (the JAX package's host runtime), built
// by arcanefem_tpu_torch/utils/native.py.  Keep the two in step.
//
// Native AMG-setup hot path (scalar bl=1 levels).
//
// The SA-AMG setup (solver/amg.py::build_amg) spent ~35-45 s host-side at
// 1.9M DoF, dominated by scipy/numpy passes that materialize several
// nnz-sized temporaries each: strength test (~6 s), strong-filter +
// searchsorted membership (~9 s), prolongator smoothing + row truncation
// (~6 s).  These are single-pass CSR traversals in C++.  Role reference:
// Hypre's BoomerAMG setup runs this phase in 0.5-1.5 s at 10M rows on
// device (femutils/HypreDoFLinearSystem.cc:730 timer); this file is the
// host half of closing that class gap (the spectral-radius estimates move
// to the TPU separately).
//
// Numerics are kept IDENTICAL to the scipy path:
//  * strength:  |a_ij| >= theta * sqrt(|a_ii * a_jj|), i != j
//  * filter:    weak off-diagonals dropped, their values lumped onto the
//               row's diagonal entry (explicit zeros keep A's pattern)
//  * smoothP:   P = (I - c * Dinv_f * A_f) @ T with T[i, agg[i]] = 1,
//               then per-row truncation: keep the kmax largest-|.|,
//               drop < rel * rowmax, rescale survivors to preserve the
//               row sum (clipped to +-4, only where survivors carry
//               >10% of the row mass) — truncate_rows semantics.
//
// All outputs are written into caller-allocated numpy buffers (ctypes).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// Fused strength graph + filtered operator.
//  in : n, indptr[n+1], cols[nnz], data[nnz], theta
//  out: s_indptr[n+1], s_cols[nnz cap]  (strong off-diagonal pattern)
//       af_data[nnz]  (filtered values, same pattern as A; weak entries
//                      exact 0, diagonal lumped), ddf[n] (Af diagonal)
//  ret: s_nnz (or -1: a row is missing its diagonal entry)
int64_t afem_amg_strength_filter(
    int64_t n, const int64_t* indptr, const int32_t* cols,
    const double* data, double theta,
    int64_t* s_indptr, int32_t* s_cols, double* af_data, double* ddf) {
  // pass 0: diagonal
  std::vector<double> d(n, 0.0);
  std::vector<int64_t> dpos(n, -1);
  for (int64_t i = 0; i < n; ++i) {
    for (int64_t k = indptr[i]; k < indptr[i + 1]; ++k) {
      if (cols[k] == i) {
        d[i] = data[k];
        dpos[i] = k;
      }
    }
  }
  int64_t snnz = 0;
  for (int64_t i = 0; i < n; ++i) {
    if (dpos[i] < 0 && indptr[i + 1] > indptr[i]) return -1;
    s_indptr[i] = snnz;
    double drop = 0.0;
    const double di = d[i];
    for (int64_t k = indptr[i]; k < indptr[i + 1]; ++k) {
      const int32_t j = cols[k];
      const double a = data[k];
      if (j == (int32_t)i) {
        af_data[k] = a;  // diagonal: lump added after the row scan
        continue;
      }
      const double scale = std::sqrt(std::fabs(di * d[j])) + 1e-300;
      if (std::fabs(a) >= theta * scale) {
        s_cols[snnz++] = j;
        af_data[k] = a;
      } else {
        af_data[k] = 0.0;
        drop += a;
      }
    }
    if (dpos[i] >= 0) af_data[dpos[i]] += drop;
    ddf[i] = dpos[i] >= 0 ? af_data[dpos[i]] : 0.0;
  }
  s_indptr[n] = snnz;
  return snnz;
}

// Fused prolongator smoothing + row truncation (scalar tentative).
//  P = (I - c * Dinv_f * A_f) @ T,  T[i, agg[i]] = 1 for agg[i] >= 0.
//  in : n, indptr/cols/af_data (the FILTERED operator, explicit zeros ok),
//       ddf[n], c, agg[n] (int64, -1 = no aggregate), na,
//       kmax, rel, rescale (0/1)
//  out: p_indptr[n+1], p_cols[cap], p_data[cap]; cap >= n*kmax.
//  ret: p_nnz
int64_t afem_amg_smooth_p(
    int64_t n, const int64_t* indptr, const int32_t* cols,
    const double* af_data, const double* ddf, double c,
    const int64_t* agg, int64_t na, int32_t kmax, double rel,
    int32_t rescale,
    int64_t* p_indptr, int32_t* p_cols, double* p_data) {
  std::vector<double> acc(na, 0.0);
  std::vector<int64_t> stamp(na, -1);
  std::vector<int64_t> touched;
  touched.reserve(64);
  struct Ent {
    int64_t col;
    double val;
    int32_t pos;  // accumulation order — the scipy lexsort tie-break is
                  // by CSR entry order; we match "stable among equal |v|"
  };
  std::vector<Ent> row;
  row.reserve(64);
  int64_t pnnz = 0;
  for (int64_t i = 0; i < n; ++i) {
    p_indptr[i] = pnnz;
    touched.clear();
    // scipy parity: Dinv_f uses 1/where(ddf==0, 1, ddf)
    const double ci = c / (ddf[i] != 0.0 ? ddf[i] : 1.0);
    if (agg[i] >= 0) {
      const int64_t t = agg[i];
      if (stamp[t] != i) { stamp[t] = i; acc[t] = 0.0; touched.push_back(t); }
      acc[t] += 1.0;
    }
    for (int64_t k = indptr[i]; k < indptr[i + 1]; ++k) {
      const int64_t t = agg[cols[k]];
      if (t < 0) continue;
      const double v = -ci * af_data[k];
      if (stamp[t] != i) { stamp[t] = i; acc[t] = 0.0; touched.push_back(t); }
      acc[t] += v;
    }
    if (touched.empty()) continue;
    row.clear();
    double full = 0.0, rowmax = 0.0;
    for (size_t u = 0; u < touched.size(); ++u) {
      const int64_t t = touched[u];
      const double v = acc[t];
      full += v;
      const double av = std::fabs(v);
      if (av > rowmax) rowmax = av;
      if (v != 0.0) row.push_back({t, v, (int32_t)u});
    }
    // top-kmax by |v| (stable on accumulation order), then rel threshold
    if ((int64_t)row.size() > kmax) {
      std::stable_sort(row.begin(), row.end(), [](const Ent& a, const Ent& b) {
        return std::fabs(a.val) > std::fabs(b.val);
      });
      row.resize(kmax);
    }
    const double thr = rel * rowmax;
    double kept = 0.0;
    size_t w = 0;
    for (size_t u = 0; u < row.size(); ++u) {
      if (std::fabs(row[u].val) >= thr) {
        row[w++] = row[u];
        kept += row[u].val;
      }
    }
    row.resize(w);
    if (row.empty()) continue;
    double scale = 1.0;
    if (rescale) {
      const bool ok = std::fabs(kept) > 0.1 * std::fabs(full);
      if (ok) {
        double raw = full / kept;
        if (raw > 4.0) raw = 4.0;
        if (raw < -4.0) raw = -4.0;
        scale = raw;
      }
    }
    std::sort(row.begin(), row.end(),
              [](const Ent& a, const Ent& b) { return a.col < b.col; });
    for (const Ent& e : row) {
      p_cols[pnnz] = (int32_t)e.col;
      p_data[pnnz] = e.val * scale;
      ++pnnz;
    }
  }
  p_indptr[n] = pnnz;
  return pnnz;
}

}  // extern "C"
