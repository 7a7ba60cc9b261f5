// Native host kernels of the PyTorch port's preprocessing: the port's own
// copy of the JAX package's native/graphlib.cpp, unchanged in what it
// computes, so that both packages build the same patches and pyramids.
//
// Implements the two sequential preprocessing hot loops that cannot be
// vectorized on the host:
//   - match_one_level: one pass of Graclus greedy heavy-edge matching
//     (semantics of the reference lib/coarsening.py:135-192)
//   - grow_patch: masked BFS facet-graph patch growth
//     (semantics of the reference utils.py:1508-1696)
//
// Exposed with a C ABI and consumed via ctypes
// (facet_graph_convolution_torch/graph/native.py), which builds it with g++
// into csrc/build/ at first use. It also parses OBJ files and builds the
// facet adjacency K-list (below).

#ifndef _GNU_SOURCE
#define _GNU_SOURCE  // strtof_l / strtoll_l / newlocale
#endif

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <locale.h>
#include <vector>

extern "C" {

// Greedy heavy-edge matching over a CSR-ish edge list sorted by row.
// rr/cc/vv: edge list (rr ascending), rid: visit order, inv_w: 1/degree
// (0 for isolated nodes). Writes cluster ids; returns total association.
double match_one_level(
    const int64_t* rr, const int64_t* cc, const double* vv, int64_t nnz,
    const int64_t* rid, const double* inv_w, int64_t n,
    int32_t* cluster_id) {
  std::vector<uint8_t> marked(n, 0);
  std::vector<int64_t> rowstart(n, 0), rowlength(n, 0);
  for (int64_t i = 0; i < nnz; ++i) rowlength[rr[i]]++;
  for (int64_t i = 1; i < n; ++i) rowstart[i] = rowstart[i - 1] + rowlength[i - 1];

  double total_assoc = 0.0;
  int32_t cluster_count = 0;
  for (int64_t ii = 0; ii < n; ++ii) {
    const int64_t tid = rid[ii];
    if (marked[tid]) continue;
    marked[tid] = 1;
    const int64_t rs = rowstart[tid];
    const int64_t len = rowlength[tid];
    int64_t best = -1;
    double wmax = 0.0;
    for (int64_t jj = 0; jj < len; ++jj) {
      const int64_t nid = cc[rs + jj];
      if (marked[nid]) continue;
      const double tval = vv[rs + jj] * (inv_w[tid] + inv_w[nid]);
      if (tval > wmax) {
        wmax = tval;
        best = nid;
      }
    }
    cluster_id[tid] = cluster_count;
    if (best > -1) {
      cluster_id[best] = cluster_count;
      marked[best] = 1;
    }
    total_assoc += wmax;
    cluster_count++;
  }
  return total_assoc;
}

// Masked BFS patch growth. adj0 is the zero-indexed K-list (-1 = pad).
// out_adj is (nodes_num + k) x k, pre-filled with -1; old_idx likewise;
// new_idx is an n-sized scratch pre-filled with -1. meta = [count, next_seed].
// Returns the patch node count.
int64_t grow_patch(
    const int64_t* adj0, int64_t n, int64_t k,
    int64_t seed, int64_t nodes_num,
    const int8_t* mask, int64_t min_size,
    int64_t* out_adj, int64_t* old_idx, int64_t* new_idx, int64_t* meta) {
  std::deque<int64_t> main_q, border_q;
  int64_t count = 0;

  auto add_node = [&](int64_t g) {
    new_idx[g] = count;
    old_idx[count] = g;
    count++;
  };

  add_node(seed);
  main_q.push_back(seed);

  auto expand = [&](std::deque<int64_t>& q, int64_t limit, bool respect_mask) {
    while (count < limit && !q.empty()) {
      const int64_t cur = q.front();
      q.pop_front();
      const int64_t local = new_idx[cur];
      out_adj[local * k + 0] = local;
      for (int64_t slot = 1; slot < k; ++slot) {
        const int64_t nbr = adj0[cur * k + slot];
        if (nbr == -1) break;
        if (new_idx[nbr] == -1) {
          add_node(nbr);
          if (respect_mask && mask[nbr] == 1) {
            border_q.push_back(nbr);
          } else {
            main_q.push_back(nbr);
          }
        }
        out_adj[local * k + slot] = new_idx[nbr];
      }
    }
  };

  expand(main_q, nodes_num, /*respect_mask=*/true);

  if (count < min_size) {
    expand(border_q, min_size, /*respect_mask=*/false);
    expand(main_q, min_size, /*respect_mask=*/false);
  }

  int64_t next_seed = -1;
  std::deque<int64_t>* queues[2] = {&main_q, &border_q};
  for (auto* q : queues) {
    while (!q->empty()) {
      const int64_t cur = q->front();
      q->pop_front();
      const int64_t local = new_idx[cur];
      out_adj[local * k + 0] = local;
      int64_t fill = 1;
      for (int64_t slot = 1; slot < k; ++slot) {
        const int64_t nbr = adj0[cur * k + slot];
        if (nbr == -1) break;
        if (new_idx[nbr] == -1) {
          if (mask[nbr] == 0) next_seed = nbr;
          continue;
        }
        out_adj[local * k + fill] = new_idx[nbr];
        fill++;
      }
    }
  }

  meta[0] = count;
  meta[1] = next_seed;
  return count;
}

// Vertex-shared facet adjacency K-list (reference getFacesLargeAdj,
// utils.py:243-295; exact semantics of the vectorized Python builder in
// facet_graph_convolution_torch/graph/adjacency.py, which documents the one
// degenerate-face deviation from the reference). faces: [F,3] (0-indexed),
// fadj: [F,k] int32 pre-zeroed output (slot 0 = self, one-indexed, filled
// here). Returns the number of dropped directed connections (overflow past
// k-1 neighbours). Single pass over per-vertex incidence pairs — no sorts,
// no large temporaries (the sort-based Python path moves ~10 arrays of
// Σ_v deg² entries through memory; at 1.3M facets that is seconds on a
// bandwidth-poor host, ~0.2 s here).
int64_t face_adjacency(
    const int64_t* faces, int64_t fnum, int64_t vnum, int64_t k,
    int32_t* fadj) {
  // CSR incidence: faces scanned ascending => per-vertex lists ascending;
  // a degenerate face with a repeated vertex records once per occurrence
  std::vector<int64_t> off(vnum + 1, 0);
  for (int64_t i = 0; i < fnum * 3; ++i) off[faces[i] + 1]++;
  for (int64_t v = 0; v < vnum; ++v) off[v + 1] += off[v];
  std::vector<int64_t> inc(fnum * 3);
  std::vector<int64_t> cur(off.begin(), off.end() - 1);
  for (int64_t f = 0; f < fnum; ++f)
    for (int j = 0; j < 3; ++j) inc[cur[faces[f * 3 + j]]++] = f;

  std::vector<int32_t> cnt(fnum, 0);   // filled neighbour slots per face
  int64_t dropped = 0;
  for (int64_t f = 0; f < fnum; ++f) fadj[f * k] = static_cast<int32_t>(f) + 1;
  for (int64_t v = 0; v < vnum; ++v) {
    const int64_t s = off[v], e = off[v + 1];
    for (int64_t i = s; i < e; ++i) {
      const int64_t a = inc[i];
      for (int64_t j = i + 1; j < e; ++j) {
        const int64_t b = inc[j];
        // reference order: b into a's list, then a into b's list
        if (cnt[a] < k - 1) {
          fadj[a * k + 1 + cnt[a]++] = static_cast<int32_t>(b) + 1;
        } else {
          dropped++;
        }
        if (cnt[b] < k - 1) {
          fadj[b * k + 1 + cnt[b]++] = static_cast<int32_t>(a) + 1;
        } else {
          dropped++;
        }
      }
    }
  }
  return dropped;
}

// ---------------------------------------------------------------------------
// OBJ parser fast path. Exact semantics of the Python loader
// (facet_graph_convolution_torch/geometry/obj_io.load_obj, which mirrors the
// reference utils.py:476-639): 'v' lines yield the first 3 floats; 'f' lines
// yield the signed integer before the first '/' of each vertex token,
// 1-indexed, fan-triangulated; '#'-comments and every other tag are skipped.
//
// Two-call protocol via an opaque handle (the caller cannot size the output
// before parsing):
//   obj_parse(path, &n_verts, &n_tris) -> handle (NULL on open failure)
//   obj_copy(handle, verts[n_verts*3] f32, tris[n_tris*3] i64)  frees handle
//   obj_release(handle)                                         on abort
// ---------------------------------------------------------------------------

struct ObjData {
  std::vector<float> verts;
  std::vector<int64_t> tris;
};

}  // extern "C"

static inline const char* skip_ws(const char* p, const char* end) {
  while (p < end && (*p == ' ' || *p == '\t' || *p == '\r')) ++p;
  return p;
}

static inline const char* skip_token(const char* p, const char* end) {
  while (p < end && *p != ' ' && *p != '\t' && *p != '\r' && *p != '\n') ++p;
  return p;
}

extern "C" {

void* obj_parse(const char* path, int64_t* n_verts, int64_t* n_tris) {
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;
  if (fseek(f, 0, SEEK_END) != 0) { fclose(f); return nullptr; }
  const long sz = ftell(f);
  if (sz < 0 || fseek(f, 0, SEEK_SET) != 0) { fclose(f); return nullptr; }
  // +2: a '\n' sentinel terminating the last line and a '\0' stopping
  // strtof/strtoll (which skip '\n' as leading whitespace and would
  // otherwise read past the buffer on a truncated final line)
  std::vector<char> buf(static_cast<size_t>(sz) + 2);
  const size_t got = fread(buf.data(), 1, static_cast<size_t>(sz), f);
  fclose(f);
  if (got != static_cast<size_t>(sz)) return nullptr;  // dir/special file
  buf[got] = '\n';
  buf[got + 1] = '\0';
  const char* p = buf.data();
  const char* end = buf.data() + got + 1;  // points AT the '\0'

  // strtof is LC_NUMERIC-sensitive (a de_DE host would parse "1.5" as 1);
  // pin the C locale like Python's float()
  static locale_t c_loc = newlocale(LC_ALL_MASK, "C", (locale_t)0);

  auto* data = new ObjData();
  std::vector<int64_t> poly;
  bool ok = true;
  while (ok && p < end) {
    p = skip_ws(p, end);
    if (p >= end) break;
    if (*p == 'v' && (p + 1 < end) && (p[1] == ' ' || p[1] == '\t')) {
      ++p;
      for (int i = 0; i < 3; ++i) {
        // position at the token ourselves: strtof_l skips '\n' as leading
        // whitespace, so a short 'v' line followed by a line starting with
        // a number would silently pull coords across lines (the Python
        // loader raises on the ragged vertex list instead)
        p = skip_ws(p, end);
        if (p >= end || *p == '\n') { ok = false; break; }
        char* q;
        const float v = strtof_l(p, &q, c_loc);
        if (q == p) { ok = false; break; }  // <3 coords — Python raises too
        data->verts.push_back(v);
        p = q;
      }
    } else if (*p == 'f' && (p + 1 < end) && (p[1] == ' ' || p[1] == '\t')) {
      ++p;
      poly.clear();
      for (;;) {
        p = skip_ws(p, end);
        if (p >= end || *p == '\n') break;
        char* q;
        const long long idx = strtoll_l(p, &q, 10, c_loc);
        if (q == p || idx < 1) {
          // malformed token or negative/zero (relative) index: the Python
          // loader errors on these — refuse so the caller falls back
          ok = false;
          break;
        }
        poly.push_back(static_cast<int64_t>(idx) - 1);
        p = skip_token(q, end);  // drop /texture/normal parts
      }
      for (size_t t = 0; poly.size() >= 3 && t < poly.size() - 2; ++t) {
        data->tris.push_back(poly[0]);
        data->tris.push_back(poly[t + 1]);
        data->tris.push_back(poly[t + 2]);
      }
    }
    while (p < end && *p != '\n') ++p;  // rest of line (or unknown tag)
    ++p;
  }
  if (!ok) {
    delete data;
    return nullptr;
  }
  *n_verts = static_cast<int64_t>(data->verts.size() / 3);
  *n_tris = static_cast<int64_t>(data->tris.size() / 3);
  return data;
}

void obj_copy(void* handle, float* verts, int64_t* tris) {
  auto* data = static_cast<ObjData*>(handle);
  std::memcpy(verts, data->verts.data(), data->verts.size() * sizeof(float));
  std::memcpy(tris, data->tris.data(), data->tris.size() * sizeof(int64_t));
  delete data;
}

void obj_release(void* handle) { delete static_cast<ObjData*>(handle); }

}  // extern "C"
