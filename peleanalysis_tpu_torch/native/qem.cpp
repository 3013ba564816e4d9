// Quadric-error-metric mesh decimation (Garland-Heckbert greedy edge
// collapse): the reference's decimateMEF (Src/decimateMEF.cpp with the
// vendored Tools/qslim; config surface per Tools/qslim/qslim.h:29-46:
// face_target, boundary_weight).  Written from the published algorithm
// (Garland & Heckbert, SIGGRAPH '97), not ported from mixkit.  A copy of
// peleanalysis_tpu/native/qem.cpp (code unchanged), so the port decimates
// to the same bytes.
//
// Greedy collapse is inherently sequential, so it lives in native C++ on the
// host; exposed through a C ABI consumed via ctypes.
//
// Per-vertex attributes (the MEF's non-coordinate components) are carried
// through collapses by error-weighted interpolation of the two endpoints.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <queue>
#include <unordered_map>
#include <unordered_set>
#include <vector>

namespace {

struct Quadric {
  // symmetric 4x4: a2 ab ac ad b2 bc bd c2 cd d2
  double q[10] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0};
  void add_plane(double a, double b, double c, double d, double w) {
    q[0] += w * a * a; q[1] += w * a * b; q[2] += w * a * c; q[3] += w * a * d;
    q[4] += w * b * b; q[5] += w * b * c; q[6] += w * b * d;
    q[7] += w * c * c; q[8] += w * c * d; q[9] += w * d * d;
  }
  void add(const Quadric& o) { for (int i = 0; i < 10; ++i) q[i] += o.q[i]; }
  double eval(const double* v) const {
    double x = v[0], y = v[1], z = v[2];
    return q[0]*x*x + 2*q[1]*x*y + 2*q[2]*x*z + 2*q[3]*x
         + q[4]*y*y + 2*q[5]*y*z + 2*q[6]*y
         + q[7]*z*z + 2*q[8]*z + q[9];
  }
  // solve for minimizing point; false if near-singular
  bool optimum(double* out) const {
    double A[9] = {q[0], q[1], q[2], q[1], q[4], q[5], q[2], q[5], q[7]};
    double b[3] = {-q[3], -q[6], -q[8]};
    // Cramer with pivot check
    double det = A[0]*(A[4]*A[8]-A[5]*A[7]) - A[1]*(A[3]*A[8]-A[5]*A[6])
               + A[2]*(A[3]*A[7]-A[4]*A[6]);
    if (std::fabs(det) < 1e-12) return false;
    double inv = 1.0 / det;
    out[0] = inv * (b[0]*(A[4]*A[8]-A[5]*A[7]) - A[1]*(b[1]*A[8]-A[5]*b[2])
                    + A[2]*(b[1]*A[7]-A[4]*b[2]));
    out[1] = inv * (A[0]*(b[1]*A[8]-A[5]*b[2]) - b[0]*(A[3]*A[8]-A[5]*A[6])
                    + A[2]*(A[3]*b[2]-b[1]*A[6]));
    out[2] = inv * (A[0]*(A[4]*b[2]-b[1]*A[7]) - A[1]*(A[3]*b[2]-b[1]*A[6])
                    + b[0]*(A[3]*A[7]-A[4]*A[6]));
    return true;
  }
};

struct HeapEntry {
  double cost;
  int v0, v1;
  uint64_t stamp;  // validity check: sum of endpoint versions at push time
  bool operator<(const HeapEntry& o) const { return cost > o.cost; }
};

inline uint64_t ekey(int a, int b) {
  if (a > b) std::swap(a, b);
  return (uint64_t(a) << 32) | uint64_t(b);
}

}  // namespace

extern "C" int qem_decimate(
    int n_verts, int n_tris, int n_attr,
    const double* verts,      // [n_verts, 3]
    const double* attrs,      // [n_verts, n_attr] or null
    const int* tris,          // [n_tris, 3]
    int face_target,
    double boundary_weight,
    int placement_policy,     // 0=endpoints 1=endormid 2=line 3=optimal
                              //   (qslim -O, cmdline.cpp:25-27)
    int weighting_policy,     // 0=uniform 1=area 2=angle (qslim -W)
    double meshing_penalty,   // cost multiplier per normal-flipping /
                              //   sub-compact face a collapse would create
                              //   (qslim -m; deviation: mixkit adds a fixed
                              //   bias, we scale — ordering-equivalent)
    double compactness_ratio, // faces below this compactness count as bad
                              //   when meshing_penalty > 1 (qslim -c)
    double* out_verts,        // [n_verts, 3] capacity
    double* out_attrs,        // [n_verts, n_attr] capacity
    int* out_tris,            // [n_tris, 3] capacity
    int* out_counts)          // {n_out_verts, n_out_tris}
{
  std::vector<double> V(verts, verts + size_t(n_verts) * 3);
  std::vector<double> A;
  if (n_attr > 0) A.assign(attrs, attrs + size_t(n_verts) * n_attr);
  std::vector<int> F(tris, tris + size_t(n_tris) * 3);
  std::vector<char> face_dead(n_tris, 0);
  std::vector<uint64_t> version(n_verts, 0);
  std::vector<Quadric> Q(n_verts);
  std::vector<std::unordered_set<int>> vfaces(n_verts);

  // face quadrics (weighting_policy: 0=uniform, 1=area, 2=interior angle
  // at each vertex — per qslim -W)
  for (int f = 0; f < n_tris; ++f) {
    int i = F[3*f], j = F[3*f+1], k = F[3*f+2];
    if (i == j || j == k || i == k) { face_dead[f] = 1; continue; }
    const double *p = &V[3*i], *q = &V[3*j], *r = &V[3*k];
    double u[3] = {q[0]-p[0], q[1]-p[1], q[2]-p[2]};
    double w[3] = {r[0]-p[0], r[1]-p[1], r[2]-p[2]};
    double n[3] = {u[1]*w[2]-u[2]*w[1], u[2]*w[0]-u[0]*w[2],
                   u[0]*w[1]-u[1]*w[0]};
    double len = std::sqrt(n[0]*n[0]+n[1]*n[1]+n[2]*n[2]);
    double area = 0.5 * len;
    if (len < 1e-300) { continue; }
    for (int d = 0; d < 3; ++d) n[d] /= len;
    double dd = -(n[0]*p[0] + n[1]*p[1] + n[2]*p[2]);
    double wv[3] = {area, area, area};
    if (weighting_policy == 0) {
      wv[0] = wv[1] = wv[2] = 1.0;
    } else if (weighting_policy == 2) {
      const int vid[3] = {i, j, k};
      for (int c = 0; c < 3; ++c) {
        const double *a0 = &V[3*vid[c]];
        const double *a1 = &V[3*vid[(c + 1) % 3]];
        const double *a2 = &V[3*vid[(c + 2) % 3]];
        double e1[3] = {a1[0]-a0[0], a1[1]-a0[1], a1[2]-a0[2]};
        double e2[3] = {a2[0]-a0[0], a2[1]-a0[1], a2[2]-a0[2]};
        double l1 = std::sqrt(e1[0]*e1[0]+e1[1]*e1[1]+e1[2]*e1[2]);
        double l2 = std::sqrt(e2[0]*e2[0]+e2[1]*e2[1]+e2[2]*e2[2]);
        double cosang = (e1[0]*e2[0]+e1[1]*e2[1]+e1[2]*e2[2])
                        / std::max(l1 * l2, 1e-300);
        wv[c] = std::acos(std::min(1.0, std::max(-1.0, cosang)));
      }
    }
    Q[i].add_plane(n[0], n[1], n[2], dd, wv[0]);
    Q[j].add_plane(n[0], n[1], n[2], dd, wv[1]);
    Q[k].add_plane(n[0], n[1], n[2], dd, wv[2]);
    vfaces[i].insert(f); vfaces[j].insert(f); vfaces[k].insert(f);
  }

  // boundary constraint quadrics: edges with exactly one incident face get
  // a perpendicular penalty plane (qslim boundary_weight analog)
  {
    std::unordered_map<uint64_t, int> edge_count;
    std::unordered_map<uint64_t, int> edge_face;
    for (int f = 0; f < n_tris; ++f) {
      if (face_dead[f]) continue;
      for (int e = 0; e < 3; ++e) {
        int a = F[3*f + e], b = F[3*f + (e+1)%3];
        edge_count[ekey(a, b)]++;
        edge_face[ekey(a, b)] = f;
      }
    }
    for (auto& kv : edge_count) {
      if (kv.second != 1 || boundary_weight <= 0) continue;
      int a = int(kv.first >> 32), b = int(kv.first & 0xffffffffu);
      int f = edge_face[kv.first];
      int i = F[3*f], j = F[3*f+1], k = F[3*f+2];
      const double *p = &V[3*i], *q = &V[3*j], *r = &V[3*k];
      double u[3] = {q[0]-p[0], q[1]-p[1], q[2]-p[2]};
      double w[3] = {r[0]-p[0], r[1]-p[1], r[2]-p[2]};
      double fn[3] = {u[1]*w[2]-u[2]*w[1], u[2]*w[0]-u[0]*w[2],
                      u[0]*w[1]-u[1]*w[0]};
      double e0[3] = {V[3*b]-V[3*a], V[3*b+1]-V[3*a+1], V[3*b+2]-V[3*a+2]};
      // plane containing the edge, perpendicular to the face
      double n[3] = {e0[1]*fn[2]-e0[2]*fn[1], e0[2]*fn[0]-e0[0]*fn[2],
                     e0[0]*fn[1]-e0[1]*fn[0]};
      double len = std::sqrt(n[0]*n[0]+n[1]*n[1]+n[2]*n[2]);
      if (len < 1e-300) continue;
      for (int d = 0; d < 3; ++d) n[d] /= len;
      double dd = -(n[0]*V[3*a] + n[1]*V[3*a+1] + n[2]*V[3*a+2]);
      Q[a].add_plane(n[0], n[1], n[2], dd, boundary_weight);
      Q[b].add_plane(n[0], n[1], n[2], dd, boundary_weight);
    }
  }

  std::vector<int> remap(n_verts);
  for (int i = 0; i < n_verts; ++i) remap[i] = i;

  auto best_of = [&](const Quadric& s, int a, int b, bool with_mid,
                     double* vout) -> double {
    double m[3] = {0.5*(V[3*a]+V[3*b]), 0.5*(V[3*a+1]+V[3*b+1]),
                   0.5*(V[3*a+2]+V[3*b+2])};
    double ca = s.eval(&V[3*a]), cb = s.eval(&V[3*b]);
    double cm = with_mid ? s.eval(m) : 1e300;
    if (ca <= cb && ca <= cm) { std::memcpy(vout, &V[3*a], 24); return ca; }
    if (cb <= cm) { std::memcpy(vout, &V[3*b], 24); return cb; }
    std::memcpy(vout, m, 24);
    return cm;
  };

  auto base_cost = [&](int a, int b, double* vout) -> double {
    Quadric s = Q[a];
    s.add(Q[b]);
    if (placement_policy == 0)
      return best_of(s, a, b, false, vout);
    if (placement_policy == 1)
      return best_of(s, a, b, true, vout);
    if (placement_policy == 2) {
      // best point ON the segment a->b: cost(t) is quadratic; the
      // stationary point is t* = -d.(A pa + bv) / (d.A d), clamped
      const double *pa = &V[3*a], *pb = &V[3*b];
      double d[3] = {pb[0]-pa[0], pb[1]-pa[1], pb[2]-pa[2]};
      double A[9] = {s.q[0], s.q[1], s.q[2], s.q[1], s.q[4], s.q[5],
                     s.q[2], s.q[5], s.q[7]};
      double bv[3] = {s.q[3], s.q[6], s.q[8]};
      double Ad[3] = {A[0]*d[0]+A[1]*d[1]+A[2]*d[2],
                      A[3]*d[0]+A[4]*d[1]+A[5]*d[2],
                      A[6]*d[0]+A[7]*d[1]+A[8]*d[2]};
      double denom = d[0]*Ad[0] + d[1]*Ad[1] + d[2]*Ad[2];
      if (std::fabs(denom) < 1e-300)
        return best_of(s, a, b, true, vout);
      double Apa[3] = {A[0]*pa[0]+A[1]*pa[1]+A[2]*pa[2],
                       A[3]*pa[0]+A[4]*pa[1]+A[5]*pa[2],
                       A[6]*pa[0]+A[7]*pa[1]+A[8]*pa[2]};
      double t = -(d[0]*(Apa[0]+bv[0]) + d[1]*(Apa[1]+bv[1])
                   + d[2]*(Apa[2]+bv[2])) / denom;
      t = std::min(1.0, std::max(0.0, t));
      for (int c = 0; c < 3; ++c) vout[c] = pa[c] + t * d[c];
      return s.eval(vout);
    }
    if (!s.optimum(vout))
      return best_of(s, a, b, true, vout);
    return s.eval(vout);
  };

  auto face_quality = [&](const double* p, const double* q,
                          const double* r, double* normal) -> double {
    // compactness 4*sqrt(3)*area / sum(edge^2) in (0, 1]; also returns the
    // (unnormalized) face normal
    double u[3] = {q[0]-p[0], q[1]-p[1], q[2]-p[2]};
    double w[3] = {r[0]-p[0], r[1]-p[1], r[2]-p[2]};
    normal[0] = u[1]*w[2]-u[2]*w[1];
    normal[1] = u[2]*w[0]-u[0]*w[2];
    normal[2] = u[0]*w[1]-u[1]*w[0];
    double area = 0.5 * std::sqrt(normal[0]*normal[0]
                                  + normal[1]*normal[1]
                                  + normal[2]*normal[2]);
    double e2 = 0;
    const double* vs[3] = {p, q, r};
    for (int e = 0; e < 3; ++e) {
      const double *x = vs[e], *y = vs[(e+1)%3];
      for (int c = 0; c < 3; ++c)
        e2 += (y[c]-x[c]) * (y[c]-x[c]);
    }
    return e2 > 1e-300 ? 4.0 * std::sqrt(3.0) * area / e2 : 0.0;
  };

  auto edge_cost = [&](int a, int b, double* vout) -> double {
    double cost = base_cost(a, b, vout);
    if (meshing_penalty > 1.0) {
      // count faces the collapse would flip or squash below the
      // compactness floor (qslim's local-validity checks, -m / -c)
      int n_bad = 0;
      const int ends[2] = {a, b};
      for (int s2 = 0; s2 < 2; ++s2) {
        for (int f : vfaces[ends[s2]]) {
          if (face_dead[f]) continue;
          int vi[3];
          bool dies = false;
          for (int e = 0; e < 3; ++e) {
            int v = F[3*f + e];
            while (remap[v] != v) v = remap[v];
            vi[e] = v;
          }
          // faces containing both endpoints die in the collapse
          bool hasa = false, hasb = false;
          for (int e = 0; e < 3; ++e) {
            hasa |= vi[e] == a;
            hasb |= vi[e] == b;
          }
          if ((hasa && hasb) || (s2 == 1 && hasa)) dies = true;
          if (dies) continue;
          const double* pts_old[3];
          double pts_new[3][3];
          for (int e = 0; e < 3; ++e) {
            pts_old[e] = &V[3*vi[e]];
            const double* src = (vi[e] == a || vi[e] == b) ? vout
                                                           : &V[3*vi[e]];
            std::memcpy(pts_new[e], src, 24);
          }
          double n_old[3], n_new[3];
          face_quality(pts_old[0], pts_old[1], pts_old[2], n_old);
          double comp = face_quality(pts_new[0], pts_new[1], pts_new[2],
                                     n_new);
          double dot = n_old[0]*n_new[0] + n_old[1]*n_new[1]
                       + n_old[2]*n_new[2];
          if (dot <= 0.0 || comp < compactness_ratio) n_bad++;
        }
      }
      if (n_bad > 0)
        cost = (cost + 1e-12) * (1.0 + meshing_penalty * n_bad);
    }
    return cost;
  };

  std::priority_queue<HeapEntry> heap;
  std::unordered_set<uint64_t> edges;
  for (int f = 0; f < n_tris; ++f) {
    if (face_dead[f]) continue;
    for (int e = 0; e < 3; ++e) {
      int a = F[3*f + e], b = F[3*f + (e+1)%3];
      uint64_t k = ekey(a, b);
      if (edges.insert(k).second) {
        double v[3];
        double c = edge_cost(a, b, v);
        heap.push({c, std::min(a, b), std::max(a, b), 0});
      }
    }
  }

  auto find = [&](int v) {
    while (remap[v] != v) { remap[v] = remap[remap[v]]; v = remap[v]; }
    return v;
  };

  int live_faces = 0;
  for (int f = 0; f < n_tris; ++f) if (!face_dead[f]) live_faces++;

  while (live_faces > face_target && !heap.empty()) {
    HeapEntry e = heap.top();
    heap.pop();
    int a = find(e.v0), b = find(e.v1);
    if (a == b) continue;
    if (e.stamp != version[a] + version[b]) continue;  // stale
    double vnew[3];
    double cost = edge_cost(a, b, vnew);
    (void)cost;
    // collapse b into a
    remap[b] = a;
    std::memcpy(&V[3*a], vnew, 24);
    if (n_attr > 0)
      for (int t = 0; t < n_attr; ++t)
        A[size_t(a)*n_attr + t] = 0.5 * (A[size_t(a)*n_attr + t]
                                         + A[size_t(b)*n_attr + t]);
    Q[a].add(Q[b]);
    version[a]++;
    // update faces
    for (int f : vfaces[b]) vfaces[a].insert(f);
    std::vector<int> drop;
    for (int f : vfaces[a]) {
      if (face_dead[f]) { drop.push_back(f); continue; }
      int i = find(F[3*f]), j = find(F[3*f+1]), k = find(F[3*f+2]);
      if (i == j || j == k || i == k) {
        face_dead[f] = 1;
        live_faces--;
        drop.push_back(f);
      }
    }
    for (int f : drop) vfaces[a].erase(f);
    // re-push neighborhood edges
    std::unordered_set<int> nbrs;
    for (int f : vfaces[a]) {
      for (int e2 = 0; e2 < 3; ++e2) {
        int v = find(F[3*f + e2]);
        if (v != a) nbrs.insert(v);
      }
    }
    for (int v : nbrs) {
      double tmp[3];
      double c = edge_cost(a, v, tmp);
      heap.push({c, a, v, version[a] + version[v]});
    }
  }

  // compact output
  std::vector<int> new_id(n_verts, -1);
  int nv = 0;
  int nf = 0;
  for (int f = 0; f < n_tris; ++f) {
    if (face_dead[f]) continue;
    int ids[3];
    bool ok = true;
    for (int e = 0; e < 3; ++e) {
      int v = find(F[3*f + e]);
      ids[e] = v;
    }
    if (ids[0] == ids[1] || ids[1] == ids[2] || ids[0] == ids[2]) continue;
    for (int e = 0; e < 3; ++e) {
      int v = ids[e];
      if (new_id[v] < 0) {
        new_id[v] = nv;
        std::memcpy(&out_verts[3*nv], &V[3*v], 24);
        if (n_attr > 0)
          std::memcpy(&out_attrs[size_t(nv)*n_attr], &A[size_t(v)*n_attr],
                      sizeof(double)*n_attr);
        nv++;
      }
      out_tris[3*nf + e] = new_id[v];
    }
    nf++;
    (void)ok;
  }
  out_counts[0] = nv;
  out_counts[1] = nf;
  return 0;
}
