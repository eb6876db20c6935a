// Native host precompute for dolfinx_eqlb_tpu_torch (copied from the JAX
// package's native layer, minus its TPU-only combine-table shaping).
//
// The reference's native layer (cpp/dolfinx_eqlb) does per-patch assembly and
// solves; in the TPU design all floating-point work lives in XLA, so the
// native layer owns the integer-heavy mesh precompute instead: facet
// extraction and the vertex-patch walk (the analogue of
// ev/Patch.cpp:222-309 fcti_to_celli and se/Patch.cpp:406-635).
//
// Exposed via a plain C ABI for ctypes; build: g++ -O3 -shared -fPIC.

#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <vector>

extern "C" {

// Facet extraction: unique sorted vertex pairs over all cell edges.
// cells: (nc, 3) int32.  Outputs (caller allocates to capacity 3*nc):
//   facet_vertices (.., 2), cell_facets (nc, 3), facet_cells (.., 2) (-1 pad),
//   facet_local (.., 2).  Returns the number of facets.
int64_t build_facets(int64_t nc, const int32_t* cells, int64_t nv,
                     int32_t* facet_vertices, int32_t* cell_facets,
                     int32_t* facet_cells, int32_t* facet_local) {
  // local edge i is opposite local vertex i, vertices ascending-local-order
  static const int LOC[3][2] = {{1, 2}, {0, 2}, {0, 1}};
  std::unordered_map<uint64_t, int32_t> fmap;
  fmap.reserve(static_cast<size_t>(2 * nc));
  int64_t nf = 0;
  for (int64_t c = 0; c < nc; ++c) {
    for (int e = 0; e < 3; ++e) {
      int32_t a = cells[3 * c + LOC[e][0]];
      int32_t b = cells[3 * c + LOC[e][1]];
      int32_t lo = a < b ? a : b, hi = a < b ? b : a;
      uint64_t key = (static_cast<uint64_t>(lo) * static_cast<uint64_t>(nv)) +
                     static_cast<uint64_t>(hi);
      auto it = fmap.find(key);
      int32_t f;
      if (it == fmap.end()) {
        f = static_cast<int32_t>(nf++);
        fmap.emplace(key, f);
        facet_vertices[2 * f] = lo;
        facet_vertices[2 * f + 1] = hi;
        facet_cells[2 * f] = static_cast<int32_t>(c);
        facet_cells[2 * f + 1] = -1;
        facet_local[2 * f] = e;
        facet_local[2 * f + 1] = -1;
      } else {
        f = it->second;
        if (facet_cells[2 * f + 1] != -1) return -1;  // non-manifold
        facet_cells[2 * f + 1] = static_cast<int32_t>(c);
        facet_local[2 * f + 1] = e;
      }
      cell_facets[3 * c + e] = f;
    }
  }
  return nf;
}

// Vertex-patch walk.  Inputs: mesh tables + vertex->cell counts; outputs are
// dense (nv, nmax)-shaped tables in walk order, -1 padded, plus spokes
// (nv, nmax + 1).  Matches eqlb.patches.build_patches: boundary vertices
// start at their smallest boundary spoke, interior at their smallest spoke,
// interior direction = facet_cells[f][0] first.
int walk_patches(int64_t nv, int64_t nf, int64_t nmax,
                 const int32_t* cells,         // (nc, 3)
                 const int32_t* cell_facets,   // (nc, 3)
                 const int32_t* facet_cells,   // (nf, 2)
                 const int64_t* v2f_offsets,   // (nv + 1)
                 const int32_t* v2f_data,
                 const uint8_t* fct_on_boundary,  // (nf,)
                 const int64_t* counts,           // (nv,) cells per vertex
                 int32_t* cells_w, int32_t* lnode_w, int32_t* entry_w,
                 int32_t* exit_w, int32_t* spokes_w) {
  for (int64_t z = 0; z < nv; ++z) {
    // start spoke
    int32_t start = -1;
    bool z_on_boundary = false;
    for (int64_t j = v2f_offsets[z]; j < v2f_offsets[z + 1]; ++j) {
      int32_t f = v2f_data[j];
      if (fct_on_boundary[f]) {
        if (!z_on_boundary || f < start) start = f;
        z_on_boundary = true;
      } else if (!z_on_boundary && (start < 0 || f < start)) {
        start = f;
      }
    }
    spokes_w[z * (nmax + 1)] = start;
    int32_t cur_f = start, prev_c = -1;
    int64_t n = counts[z];
    for (int64_t step = 0; step < n; ++step) {
      const int32_t* fc = facet_cells + 2 * cur_f;
      int32_t c = (fc[0] != prev_c) ? fc[0] : fc[1];
      int ln = 0;
      while (cells[3 * c + ln] != static_cast<int32_t>(z)) ++ln;
      int e_in = 0;
      while (cell_facets[3 * c + e_in] != cur_f) ++e_in;
      int e1 = (ln + 1) % 3, e2 = (ln + 2) % 3;
      int e_out = (e_in == e1) ? e2 : e1;
      int32_t f_out = cell_facets[3 * c + e_out];
      cells_w[z * nmax + step] = c;
      lnode_w[z * nmax + step] = ln;
      entry_w[z * nmax + step] = e_in;
      exit_w[z * nmax + step] = e_out;
      spokes_w[z * (nmax + 1) + step + 1] = f_out;
      prev_c = c;
      cur_f = f_out;
    }
  }
  return 0;
}

// Combine-table fill for one patch bucket: for every global dof, record the
// flat positions of its (<= 3) patch contributions.  gdofs (Ppad, nflux)
// int32 (out-of-range entries are padding); flat position of entry (p, f) is
// off + f * Ppad + p (nflux-major bucket layout).  src (ndofs, 3) must be
// pre-filled with the zero-pad slot; cur (ndofs) zero-initialised carries
// the per-dof column cursor across buckets.  Returns -1 if any dof exceeds
// 3 contributors.
int combine_fill(int64_t ndofs, int64_t Ppad, int64_t nflux, int64_t off,
                 const int32_t* gdofs, int32_t* src, uint8_t* cur) {
  for (int64_t p = 0; p < Ppad; ++p) {
    const int32_t* row = gdofs + p * nflux;
    for (int64_t f = 0; f < nflux; ++f) {
      int64_t d = row[f];
      if (d >= 0 && d < ndofs) {
        if (cur[d] >= 3) return -1;
        src[3 * d + cur[d]++] = static_cast<int32_t>(off + f * Ppad + p);
      }
    }
  }
  return 0;
}

// Canonical permutation + orientation signs for one patch bucket:
//   perm[p, i, m]        = entry_loc[p, i] * k + m            (m < k)
//   perm[p, i, k + m]    = exit_loc[p, i] * k + m
//   perm[p, i, 2k + j]   = 3k + j                             (j < kk1)
//   signs[p, i, s]       = dof_signs[cells[p, i], perm[p, i, s]]
int perm_signs_fill(int64_t P, int64_t n, int64_t k, int64_t kk1,
                    int64_t nel, const int32_t* cells,
                    const int32_t* entry_loc, const int32_t* exit_loc,
                    const double* dof_signs, int32_t* perm, double* signs) {
  int64_t nkeep = 2 * k + kk1;
  for (int64_t p = 0; p < P; ++p) {
    for (int64_t i = 0; i < n; ++i) {
      int64_t o = (p * n + i) * nkeep;
      int32_t e = entry_loc[p * n + i], x = exit_loc[p * n + i];
      const double* ds = dof_signs + int64_t(cells[p * n + i]) * nel;
      for (int64_t m = 0; m < k; ++m) {
        perm[o + m] = e * k + static_cast<int32_t>(m);
        perm[o + k + m] = x * k + static_cast<int32_t>(m);
      }
      for (int64_t j = 0; j < kk1; ++j)
        perm[o + 2 * k + j] = static_cast<int32_t>(3 * k + j);
      for (int64_t s = 0; s < nkeep; ++s) signs[o + s] = ds[perm[o + s]];
    }
  }
  return 0;
}

}  // extern "C"
