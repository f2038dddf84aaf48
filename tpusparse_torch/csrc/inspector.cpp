// tpusparse_torch native inspector: C++/OpenMP host-side pattern passes.
//
// The port's own copy of the JAX package's csrc/inspector.cpp, with the
// same entry points and the same results (tests/test_torch_native.py holds
// the two packages' outputs equal). It is host code: the plans it builds
// feed the CUDA kernels of this package. The reference library's TiledSpMM
// inspector (src/sparse_mm.cu:137-368) runs the same kind of OpenMP passes
// over a CSR pattern; here they compile it into the block-ELL plan of
// tpusparse_torch/plan.py:
//
//   pass 1 (ts_inspect_count): per row-block, count distinct column
//          blocks touched -> nslots[], global ELL width L = max
//   pass 2 (ts_inspect_fill): per row-block, emit sorted distinct column
//          blocks into block_cols[nbr*L] (padding repeats the last valid
//          id) and the per-nonzero scatter index into the packed value
//          buffer.
//
// The other entry points: the SpGEMM symbolic pass (tpusparse_torch/
// spgemm.py), the COO -> CSR counting sort, the ILU(0)/IC(0) value passes
// and the greedy aggregation of smoothed-aggregation AMG.
//
// Parallelism: row-blocks are independent; both passes parallelize over
// them with per-thread epoch-stamp scratch (no allocation in the loop).
//
// Built with g++ at first use and loaded with ctypes
// (tpusparse_torch/runtime/native.py); no pybind11 needed.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

inline int64_t cdiv(int64_t a, int64_t b) { return (a + b - 1) / b; }

struct Scratch {
  std::vector<int32_t> epoch_of;  // last epoch that touched this col-block
  std::vector<int32_t> slot_of;   // slot id assigned this epoch
  std::vector<int32_t> distinct;  // distinct col-blocks this row-block
  int32_t epoch = 0;
};

}  // namespace

extern "C" {

// Pass 1: nslots[nbr] out; returns max ELL width L (>= 1).
int64_t ts_inspect_count(const int32_t* indptr, int64_t m,
                         const int32_t* indices, int64_t k, int64_t bm,
                         int64_t bk, int32_t* nslots_out) {
  const int64_t nbr = cdiv(m, bm);
  const int64_t nbc = cdiv(k, bk);
  int64_t max_width = 1;

#pragma omp parallel reduction(max : max_width)
  {
    Scratch s;
    s.epoch_of.assign(nbc, -1);
#pragma omp for schedule(dynamic, 16)
    for (int64_t rb = 0; rb < nbr; ++rb) {
      const int64_t r0 = rb * bm;
      const int64_t r1 = std::min(r0 + bm, m);
      const int32_t epoch = s.epoch++;
      int32_t count = 0;
      for (int64_t r = r0; r < r1; ++r) {
        for (int32_t e = indptr[r]; e < indptr[r + 1]; ++e) {
          const int32_t bc = indices[e] / static_cast<int32_t>(bk);
          if (s.epoch_of[bc] != epoch) {
            s.epoch_of[bc] = epoch;
            ++count;
          }
        }
      }
      nslots_out[rb] = count;
      if (count > max_width) max_width = count;
    }
  }
  return max_width;
}

// Pass 2: block_cols[nbr*L] and scatter_idx[nnz] out.
void ts_inspect_fill(const int32_t* indptr, int64_t m, const int32_t* indices,
                     int64_t k, int64_t bm, int64_t bk, int64_t L,
                     int32_t* block_cols_out, int64_t* scatter_idx_out) {
  const int64_t nbr = cdiv(m, bm);
  const int64_t nbc = cdiv(k, bk);
  const int64_t block_elems = bm * bk;

#pragma omp parallel
  {
    Scratch s;
    s.epoch_of.assign(nbc, -1);
    s.slot_of.assign(nbc, 0);
    s.distinct.reserve(static_cast<size_t>(L));
#pragma omp for schedule(dynamic, 16)
    for (int64_t rb = 0; rb < nbr; ++rb) {
      const int64_t r0 = rb * bm;
      const int64_t r1 = std::min(r0 + bm, m);
      const int32_t epoch = s.epoch++;
      s.distinct.clear();
      for (int64_t r = r0; r < r1; ++r) {
        for (int32_t e = indptr[r]; e < indptr[r + 1]; ++e) {
          const int32_t bc = indices[e] / static_cast<int32_t>(bk);
          if (s.epoch_of[bc] != epoch) {
            s.epoch_of[bc] = epoch;
            s.distinct.push_back(bc);
          }
        }
      }
      std::sort(s.distinct.begin(), s.distinct.end());
      int32_t* row_cols = block_cols_out + rb * L;
      const int64_t count = static_cast<int64_t>(s.distinct.size());
      for (int64_t t = 0; t < count; ++t) {
        row_cols[t] = s.distinct[t];
        s.slot_of[s.distinct[t]] = static_cast<int32_t>(t);
      }
      const int32_t pad = count > 0 ? row_cols[count - 1] : 0;
      for (int64_t t = count; t < L; ++t) row_cols[t] = pad;

      for (int64_t r = r0; r < r1; ++r) {
        for (int32_t e = indptr[r]; e < indptr[r + 1]; ++e) {
          const int32_t c = indices[e];
          const int64_t slot = s.slot_of[c / static_cast<int32_t>(bk)];
          scatter_idx_out[e] = (rb * L + slot) * block_elems +
                               (r - r0) * bk + (c % static_cast<int32_t>(bk));
        }
      }
    }
  }
}

// COO -> CSR counting sort (reference TiledSpMM_coo2csr analog,
// src/sparse_mm.cu:110-134, generalized: produces a stable permutation so
// unsorted input is handled; the reference assumes row-sorted COO).
// indptr_out[m+1] and order_out[nnz] (gather indices: csr[i] = coo[order[i]]).
void ts_coo_to_csr(const int32_t* rows, int64_t nnz, int64_t m,
                   int32_t* indptr_out, int64_t* order_out) {
  std::vector<int64_t> counts(static_cast<size_t>(m) + 1, 0);
  for (int64_t e = 0; e < nnz; ++e) ++counts[rows[e] + 1];
  for (int64_t r = 0; r < m; ++r) counts[r + 1] += counts[r];
  for (int64_t r = 0; r <= m; ++r)
    indptr_out[r] = static_cast<int32_t>(counts[r]);
  std::vector<int64_t> cursor(counts.begin(), counts.end() - 1);
  for (int64_t e = 0; e < nnz; ++e) order_out[cursor[rows[e]]++] = e;
}

// SpGEMM symbolic pass (tpusparse_torch/spgemm.py's host inspector, native).
// Computes C = A @ B's CSR pattern and the flat multiplication schedule
// (a_pos, b_pos, c_pos) sorted by destination slot c_pos, so the device
// numeric pass is a sorted segment-sum. Classic SMMP-style epoch-stamped
// accumulator; two passes so Python owns all allocations.
//
// Pass 1: per-row distinct-column count -> c_indptr[m+1]; returns c_nnz
//         (or -1 if the product count overflows int32 indexing).
int64_t ts_spgemm_count(const int32_t* a_indptr, int64_t m,
                        const int32_t* a_indices, const int32_t* b_indptr,
                        const int32_t* b_indices, int64_t n,
                        int32_t* c_indptr_out) {
  std::vector<int32_t> epoch_of(static_cast<size_t>(n), -1);
  int64_t c_nnz = 0;
  int64_t nmul = 0;
  c_indptr_out[0] = 0;
  for (int64_t i = 0; i < m; ++i) {
    const int32_t epoch = static_cast<int32_t>(i);
    int64_t count = 0;
    for (int32_t p = a_indptr[i]; p < a_indptr[i + 1]; ++p) {
      const int32_t k = a_indices[p];
      nmul += b_indptr[k + 1] - b_indptr[k];
      for (int32_t q = b_indptr[k]; q < b_indptr[k + 1]; ++q) {
        const int32_t j = b_indices[q];
        if (epoch_of[j] != epoch) {
          epoch_of[j] = epoch;
          ++count;
        }
      }
    }
    c_nnz += count;
    c_indptr_out[i + 1] = static_cast<int32_t>(c_nnz);
  }
  if (nmul >= INT32_MAX || c_nnz >= INT32_MAX) return -1;
  return c_nnz;
}

// Pass 2: fill c_indices[c_nnz] (sorted within each row) and the schedule
// arrays a_pos/b_pos/c_pos[nmul], c_pos nondecreasing. A per-row counting
// sort over the slot histogram places every product without a global sort.
void ts_spgemm_fill(const int32_t* a_indptr, int64_t m,
                    const int32_t* a_indices, const int32_t* b_indptr,
                    const int32_t* b_indices, int64_t n,
                    const int32_t* c_indptr, int32_t* c_indices_out,
                    int32_t* a_pos_out, int32_t* b_pos_out,
                    int32_t* c_pos_out) {
  std::vector<int32_t> epoch_of(static_cast<size_t>(n), -1);
  std::vector<int32_t> slot_of(static_cast<size_t>(n), 0);
  std::vector<int32_t> prod_count(static_cast<size_t>(n), 0);
  std::vector<int32_t> distinct;
  std::vector<int64_t> cursor;
  int64_t sched_base = 0;
  for (int64_t i = 0; i < m; ++i) {
    const int32_t epoch = static_cast<int32_t>(i);
    distinct.clear();
    // discover distinct output columns + products per column
    for (int32_t p = a_indptr[i]; p < a_indptr[i + 1]; ++p) {
      const int32_t k = a_indices[p];
      for (int32_t q = b_indptr[k]; q < b_indptr[k + 1]; ++q) {
        const int32_t j = b_indices[q];
        if (epoch_of[j] != epoch) {
          epoch_of[j] = epoch;
          prod_count[j] = 1;
          distinct.push_back(j);
        } else {
          ++prod_count[j];
        }
      }
    }
    std::sort(distinct.begin(), distinct.end());
    const int64_t c_base = c_indptr[i];
    const int64_t row_nnz = static_cast<int64_t>(distinct.size());
    cursor.assign(static_cast<size_t>(row_nnz), 0);
    int64_t off = 0;
    for (int64_t t = 0; t < row_nnz; ++t) {
      const int32_t j = distinct[t];
      c_indices_out[c_base + t] = j;
      slot_of[j] = static_cast<int32_t>(t);
      cursor[t] = sched_base + off;
      off += prod_count[j];
    }
    // place each product at its slot-run cursor -> c_pos sorted
    for (int32_t p = a_indptr[i]; p < a_indptr[i + 1]; ++p) {
      const int32_t k = a_indices[p];
      for (int32_t q = b_indptr[k]; q < b_indptr[k + 1]; ++q) {
        const int32_t t = slot_of[b_indices[q]];
        const int64_t pos = cursor[t]++;
        a_pos_out[pos] = p;
        b_pos_out[pos] = q;
        c_pos_out[pos] = static_cast<int32_t>(c_base + t);
      }
    }
    sched_base += off;
  }
}

// ILU(0) in-place value pass (the JAX package's linalg.py factorization,
// native). Saad's IKJ variant on a CSR with SORTED indices and a present
// diagonal: row i's strict-lower entries become L (unit diagonal
// implicit), the rest becomes U. Values in fp64 for pivot accuracy.
// Epoch-stamped column->position map gives O(1) pattern lookups.
// Returns 0 on success, -(i+1) on a missing-diagonal or zero-pivot row i.
int64_t ts_ilu0(const int32_t* indptr, const int32_t* indices, int64_t n,
                double* v) {
  std::vector<int64_t> pos_of(static_cast<size_t>(n), -1);
  std::vector<int64_t> epoch(static_cast<size_t>(n), -1);
  std::vector<int64_t> diag(static_cast<size_t>(n), -1);
  for (int64_t i = 0; i < n; ++i) {
    for (int32_t p = indptr[i]; p < indptr[i + 1]; ++p) {
      pos_of[indices[p]] = p;
      epoch[indices[p]] = i;
    }
    if (epoch[i] != i) return -(i + 1);  // missing diagonal
    diag[i] = pos_of[i];
    for (int32_t p = indptr[i]; p < indptr[i + 1]; ++p) {
      const int32_t k = indices[p];
      if (k >= i) break;  // sorted: strict-lower prefix done
      const double pivot = v[diag[k]];
      if (pivot == 0.0) return -(k + 1);
      const double lik = v[p] / pivot;
      v[p] = lik;
      for (int64_t q = diag[k] + 1; q < indptr[k + 1]; ++q) {
        const int32_t j = indices[q];
        if (epoch[j] == i) v[pos_of[j]] -= lik * v[q];
      }
    }
  }
  return 0;
}

// IC(0) value pass: incomplete Cholesky on the LOWER-triangular pattern
// (indices sorted, diagonal last in each row). v holds tril(A) values in,
// L values out (L L^T ~= A on the pattern). Returns 0 on success,
// -(i+1) if row i's pivot is not positive (matrix not SPD enough for
// zero-fill IC).
int64_t ts_ic0(const int32_t* indptr, const int32_t* indices, int64_t n,
               double* v) {
  std::vector<int64_t> pos_of(static_cast<size_t>(n), -1);
  std::vector<int64_t> epoch(static_cast<size_t>(n), -1);
  std::vector<int64_t> diag(static_cast<size_t>(n), -1);
  for (int64_t i = 0; i < n; ++i) {
    for (int32_t p = indptr[i]; p < indptr[i + 1]; ++p) {
      pos_of[indices[p]] = p;
      epoch[indices[p]] = i;
    }
    if (epoch[i] != i) return -(i + 1);  // missing diagonal
    double dsum = 0.0;
    for (int32_t p = indptr[i]; p < indptr[i + 1]; ++p) {
      const int32_t j = indices[p];
      if (j >= i) break;
      // l_ij = (a_ij - sum_{k<j} l_ik l_jk) / l_jj over the shared pattern
      double s = 0.0;
      for (int64_t q = indptr[j]; q < diag[j]; ++q) {
        const int32_t k = indices[q];
        if (epoch[k] == i) s += v[pos_of[k]] * v[q];
      }
      const double lij = (v[p] - s) / v[diag[j]];
      v[p] = lij;
      dsum += lij * lij;
    }
    diag[i] = pos_of[i];
    const double d = v[diag[i]] - dsum;
    if (d <= 0.0) return -(i + 1);
    v[diag[i]] = std::sqrt(d);
  }
  return 0;
}

// Greedy aggregation over a strength graph (the JAX package's amg.py
// `_aggregate`, native). `strong` is a per-stored-entry boolean mask
// (strong off-diagonal connections). Pass 1: a node with no aggregated
// strong neighbor roots a new aggregate and absorbs its strong
// neighborhood. Pass 2: leftovers join their first aggregated strong
// neighbor. Pass 3: isolated leftovers become singletons. Inherently
// sequential (each decision depends on earlier ones) — the win over the
// Python loop is constant-factor (~100x), which is what AMG setup on
// million-row operators needs. Writes aggregate ids into `agg`,
// returns n_agg.
int64_t ts_aggregate(const int32_t* indptr, const int32_t* indices,
                     const uint8_t* strong, int64_t n, int64_t* agg) {
  for (int64_t i = 0; i < n; ++i) agg[i] = -1;
  int64_t n_agg = 0;
  for (int64_t i = 0; i < n; ++i) {
    if (agg[i] != -1) continue;
    bool clean = true;
    for (int32_t p = indptr[i]; p < indptr[i + 1]; ++p)
      if (strong[p] && agg[indices[p]] != -1) {
        clean = false;
        break;
      }
    if (!clean) continue;
    agg[i] = n_agg;
    for (int32_t p = indptr[i]; p < indptr[i + 1]; ++p)
      if (strong[p]) agg[indices[p]] = n_agg;
    ++n_agg;
  }
  for (int64_t i = 0; i < n; ++i) {
    if (agg[i] != -1) continue;
    for (int32_t p = indptr[i]; p < indptr[i + 1]; ++p)
      if (strong[p] && agg[indices[p]] != -1) {
        agg[i] = agg[indices[p]];
        break;
      }
  }
  for (int64_t i = 0; i < n; ++i)
    if (agg[i] == -1) agg[i] = n_agg++;
  return n_agg;
}

int ts_num_threads() {
#ifdef _OPENMP
  return omp_get_max_threads();
#else
  return 1;
#endif
}

}  // extern "C"
