// Wall-contour extraction: occupancy bitmap -> simplified boundary segments.
//
// Native analogue of the reference's C++ preprocessing tier (the retired
// sim_server did map processing in C++; base_classes.py:26-27). This traces
// the EXACT raster boundary between wall and free cells (grid-corner
// vertices via boundary-edge chaining, i.e. marching squares on a binary
// field) and simplifies each closed loop with Douglas-Peucker. Unlike
// center-line contour tracing (cv2.findContours), the polygon lies ON the
// cell boundary, so segment-cast scans match distance-field marching scans
// without any dilation fudge.
//
// C ABI (ctypes):
//   int extract_wall_segments(const uint8_t* wall, int h, int w,
//                             double tol_cells, double* out, int max_segs);
// wall: h*w row-major, nonzero = wall cell. out: rows [ax, ay, bx, by] in
// pixel units where vertex (x, y) is the corner between cells, i.e. world
// position = (x * resolution, y * resolution) in the map frame.
// Returns the number of segments written, or -needed if max_segs is too
// small, or -1 on allocation failure.

#include <cstdint>
#include <cstring>
#include <vector>
#include <cmath>
#include <unordered_map>

namespace {

struct V {
    double x, y;
};

// Douglas-Peucker on a polyline (open run of points), appending simplified
// segments to out.
static void dp_simplify(const std::vector<V>& pts, int lo, int hi, double tol,
                        std::vector<int>& keep) {
    if (hi <= lo + 1) return;
    const V& a = pts[lo];
    const V& b = pts[hi];
    double ex = b.x - a.x, ey = b.y - a.y;
    double len = std::sqrt(ex * ex + ey * ey);
    double dmax = -1.0;
    int imax = -1;
    for (int i = lo + 1; i < hi; ++i) {
        double d;
        if (len < 1e-12) {
            double dx = pts[i].x - a.x, dy = pts[i].y - a.y;
            d = std::sqrt(dx * dx + dy * dy);
        } else {
            d = std::fabs(ex * (pts[i].y - a.y) - ey * (pts[i].x - a.x)) / len;
        }
        if (d > dmax) { dmax = d; imax = i; }
    }
    if (dmax > tol && imax > 0) {
        dp_simplify(pts, lo, imax, tol, keep);
        keep.push_back(imax);
        dp_simplify(pts, imax, hi, tol, keep);
    }
}

}  // namespace

extern "C" int extract_wall_segments(const uint8_t* wall, int h, int w,
                                     double tol_cells, double* out,
                                     int max_segs) {
    // Boundary edges live on the corner grid (h+1) x (w+1). For each wall
    // cell with a free (or out-of-bounds) 4-neighbor, emit the shared edge,
    // oriented so the wall is on the LEFT (consistent winding lets loops be
    // chained by walking "next edge starting at my endpoint").
    const int W1 = w + 1;
    auto vid = [W1](int r, int c) { return r * W1 + c; };
    auto at = [&](int r, int c) -> bool {
        if (r < 0 || r >= h || c < 0 || c >= w) return false;
        return wall[r * w + c] != 0;
    };

    // out-edges per corner vertex: at most 2 outgoing boundary edges per
    // vertex per direction class; store up to 4.
    std::unordered_map<int64_t, int32_t> next1, next2;
    next1.reserve(size_t(h) * 4);

    auto add_edge = [&](int from, int to) {
        auto it = next1.find(from);
        if (it == next1.end()) next1.emplace(from, to);
        else next2.emplace(from, to);
    };

    int64_t n_edges = 0;
    for (int r = 0; r < h; ++r) {
        for (int c = 0; c < w; ++c) {
            if (!at(r, c)) continue;
            // neighbor below (r-1): edge along y = r, from (r,c+1) -> (r,c)
            if (!at(r - 1, c)) { add_edge(vid(r, c + 1), vid(r, c)); ++n_edges; }
            // above: edge along y = r+1, from (r+1,c) -> (r+1,c+1)
            if (!at(r + 1, c)) { add_edge(vid(r + 1, c), vid(r + 1, c + 1)); ++n_edges; }
            // left: edge along x = c, from (r,c) -> (r+1,c)
            if (!at(r, c - 1)) { add_edge(vid(r, c), vid(r + 1, c)); ++n_edges; }
            // right: edge along x = c+1, from (r+1,c+1) -> (r,c+1)
            if (!at(r, c + 1)) { add_edge(vid(r + 1, c + 1), vid(r, c + 1)); ++n_edges; }
        }
    }

    auto take_next = [&](int v, int prev_v) -> int {
        // prefer an edge that does not immediately backtrack
        auto it1 = next1.find(v);
        auto it2 = next2.find(v);
        int c1 = (it1 != next1.end()) ? it1->second : -1;
        int c2 = (it2 != next2.end()) ? it2->second : -1;
        int pick = -1;
        if (c1 >= 0 && c1 != prev_v) pick = c1;
        else if (c2 >= 0 && c2 != prev_v) pick = c2;
        else if (c1 >= 0) pick = c1;
        else if (c2 >= 0) pick = c2;
        if (pick < 0) return -1;
        if (pick == c1) next1.erase(it1);
        else next2.erase(it2);
        return pick;
    };

    int n_out = 0;
    std::vector<V> loop;
    std::vector<int> keep;
    const int W1i = W1;
    while (!next1.empty() || !next2.empty()) {
        int start = next1.empty() ? next2.begin()->first : next1.begin()->first;
        loop.clear();
        int v = start, prev = -1;
        // walk until we return to start (edges are consistently wound, so
        // every boundary edge belongs to exactly one closed loop)
        do {
            loop.push_back(V{double(v % W1i), double(v / W1i)});
            int nx = take_next(v, prev);
            if (nx < 0) break;  // defensive: open chain (shouldn't happen)
            prev = v;
            v = nx;
        } while (v != start);
        if (loop.size() < 3) continue;
        loop.push_back(loop.front());  // close

        // Douglas-Peucker, anchored at two opposite points of the ring so a
        // fully-collinear split can't collapse the loop
        keep.clear();
        int n = int(loop.size()) - 1;
        int mid = n / 2;
        keep.push_back(0);
        dp_simplify(loop, 0, mid, tol_cells, keep);
        keep.push_back(mid);
        dp_simplify(loop, mid, n, tol_cells, keep);
        keep.push_back(n);

        for (size_t i = 0; i + 1 < keep.size(); ++i) {
            const V& a = loop[keep[i]];
            const V& b = loop[keep[i + 1]];
            if (a.x == b.x && a.y == b.y) continue;
            if (n_out >= max_segs) return -(n_out + 1024);
            out[n_out * 4 + 0] = a.x;
            out[n_out * 4 + 1] = a.y;
            out[n_out * 4 + 2] = b.x;
            out[n_out * 4 + 3] = b.y;
            ++n_out;
        }
    }
    return n_out;
}
