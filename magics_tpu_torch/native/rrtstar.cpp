// RRT* global planner over a euclidean-distance-field occupancy grid.
//
// Native equivalent of the reference's `gbp_global_planner` crate
// (crates/gbp_global_planner/src/rrtstar.rs:15-83): asynchronous host-side
// RRT* pathfinding feeding the tracking factors. The reference checks
// point feasibility with parry2d collider intersection tests
// (crates/gbp_global_planner/src/lib.rs:155-178: a ball of
// `collision_radius` vs every collider); here feasibility is a bilinear
// sample of the environment's exact euclidean distance transform
// (magics_tpu_torch/env/sdf.py:distance_transform) — dist(p) > collision_radius.
// Samples are drawn uniformly from [-2000, 2000]^2 like the reference
// (lib.rs:180-185); out-of-world samples are simply infeasible.
//
// Algorithm: standard RRT* (sample -> nearest -> steer by step_size ->
// segment collision check -> choose parent in neighbourhood_radius by cost
// -> rewire), goal connection attempted whenever a new node lands within
// step_size of the goal, early exit on first goal connection (the reference
// passes stop_when_reach_goal=true). Optional shortcut smoothing
// (rrt::rrtstar::smooth_path analogue): random two-point shortcutting for
// smooth_iters iterations with feasibility sampled every smooth_step.
//
// Nearest-neighbour search uses uniform grid buckets over the world box so
// planning stays fast at the reference's max-iterations=5e6 scale.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <random>
#include <vector>

namespace {

struct Grid {
  const float* dist;  // [H, W] meters-to-nearest-obstacle
  int H, W;
  float world_w, world_h;  // meters; world is centered at origin
  float clearance;

  // world (x right, y up, origin center) -> pixel (col, row); row 0 is +y.
  // Matches the obstacle factor / collision pixel mapping
  // (factor/obstacle.rs:147-155, magics_tpu_torch/graph/tick.py:update_collisions).
  inline bool sample(float x, float y, float* out) const {
    float xf = (x + world_w * 0.5f) * (W / world_w) - 0.5f;
    float yf = (-y + world_h * 0.5f) * (H / world_h) - 0.5f;
    if (xf < 0.f) xf = 0.f;
    if (yf < 0.f) yf = 0.f;
    if (xf > (float)(W - 1)) xf = (float)(W - 1);
    if (yf > (float)(H - 1)) yf = (float)(H - 1);
    int x0 = (int)xf, y0 = (int)yf;
    int x1 = x0 + 1 < W ? x0 + 1 : x0;
    int y1 = y0 + 1 < H ? y0 + 1 : y0;
    float fx = xf - x0, fy = yf - y0;
    float d00 = dist[y0 * W + x0], d01 = dist[y0 * W + x1];
    float d10 = dist[y1 * W + x0], d11 = dist[y1 * W + x1];
    *out = (1 - fy) * ((1 - fx) * d00 + fx * d01) + fy * ((1 - fx) * d10 + fx * d11);
    return true;
  }

  inline bool feasible(float x, float y) const {
    if (x < -world_w * 0.5f || x > world_w * 0.5f || y < -world_h * 0.5f ||
        y > world_h * 0.5f)
      return false;
    float d;
    sample(x, y, &d);
    return d > clearance;
  }

  // sample feasibility along the segment every `interval` meters
  bool segment_feasible(float ax, float ay, float bx, float by,
                        float interval) const {
    float dx = bx - ax, dy = by - ay;
    float len = std::sqrt(dx * dx + dy * dy);
    int n = (int)(len / interval) + 1;
    for (int i = 1; i <= n; ++i) {
      float t = (float)i / (float)n;
      if (!feasible(ax + t * dx, ay + t * dy)) return false;
    }
    return true;
  }
};

struct Node {
  float x, y;
  int parent;
  float cost;
};

// uniform bucket index over the world box
struct Buckets {
  float world_w, world_h, cell;
  int nx, ny;
  std::vector<std::vector<int>> cells;

  Buckets(float ww, float wh, float cell_size)
      : world_w(ww), world_h(wh), cell(cell_size) {
    nx = (int)(ww / cell) + 1;
    ny = (int)(wh / cell) + 1;
    cells.resize((size_t)nx * ny);
  }
  inline int index_of(float x, float y) const {
    int cx = (int)((x + world_w * 0.5f) / cell);
    int cy = (int)((y + world_h * 0.5f) / cell);
    if (cx < 0) cx = 0;
    if (cy < 0) cy = 0;
    if (cx >= nx) cx = nx - 1;
    if (cy >= ny) cy = ny - 1;
    return cy * nx + cx;
  }
  void insert(int id, float x, float y) { cells[index_of(x, y)].push_back(id); }

  // visit all node ids in buckets overlapping the disc (x, y, r)
  template <typename F>
  void for_each_in_radius(float x, float y, float r, F&& f) const {
    int cx0 = (int)((x - r + world_w * 0.5f) / cell);
    int cy0 = (int)((y - r + world_h * 0.5f) / cell);
    int cx1 = (int)((x + r + world_w * 0.5f) / cell);
    int cy1 = (int)((y + r + world_h * 0.5f) / cell);
    if (cx0 < 0) cx0 = 0;
    if (cy0 < 0) cy0 = 0;
    if (cx1 >= nx) cx1 = nx - 1;
    if (cy1 >= ny) cy1 = ny - 1;
    for (int cy = cy0; cy <= cy1; ++cy)
      for (int cx = cx0; cx <= cx1; ++cx)
        for (int id : cells[(size_t)cy * nx + cx]) f(id);
  }

  // nearest node; expands ring search until found
  int nearest(const std::vector<Node>& nodes, float x, float y) const {
    int best = -1;
    float best_d2 = 1e30f;
    int cx = (int)((x + world_w * 0.5f) / cell);
    int cy = (int)((y + world_h * 0.5f) / cell);
    if (cx < 0) cx = 0;
    if (cy < 0) cy = 0;
    if (cx >= nx) cx = nx - 1;
    if (cy >= ny) cy = ny - 1;
    int max_ring = nx > ny ? nx : ny;
    for (int ring = 0; ring < max_ring; ++ring) {
      int x0 = cx - ring, x1 = cx + ring, y0 = cy - ring, y1 = cy + ring;
      bool any = false;
      for (int gy = y0; gy <= y1; ++gy) {
        if (gy < 0 || gy >= ny) continue;
        for (int gx = x0; gx <= x1; ++gx) {
          if (gx < 0 || gx >= nx) continue;
          // only the ring border (interior was scanned in earlier rings)
          if (ring > 0 && gx != x0 && gx != x1 && gy != y0 && gy != y1) continue;
          for (int id : cells[(size_t)gy * nx + gx]) {
            any = true;
            float dx = nodes[id].x - x, dy = nodes[id].y - y;
            float d2 = dx * dx + dy * dy;
            if (d2 < best_d2) {
              best_d2 = d2;
              best = id;
            }
          }
        }
      }
      // once something was found, one extra ring guarantees correctness
      // (a node in the next ring can still be closer than a corner hit)
      if (best >= 0 && (any || ring > 0)) {
        float r = std::sqrt(best_d2);
        if (r <= (float)ring * cell || ring == max_ring - 1) break;
      }
    }
    return best;
  }
};

}  // namespace

extern "C" {

// Returns the number of path points written to out_xy (pairs, start..goal
// order), 0 if no path was found within max_iterations, -1 on bad input.
// out_xy must hold at least 2 * max_out floats; paths longer than max_out
// are decimated by dropping interior points evenly.
int magics_rrtstar_plan(const float* dist_grid, int H, int W, float world_w,
                        float world_h, float start_x, float start_y,
                        float goal_x, float goal_y, float collision_radius,
                        float step_size, float neighbourhood_radius,
                        int64_t max_iterations, int smooth_enabled,
                        int64_t smooth_iterations, float smooth_step,
                        uint64_t seed, float* out_xy, int max_out) {
  if (!dist_grid || H <= 0 || W <= 0 || max_out < 2) return -1;
  Grid grid{dist_grid, H, W, world_w, world_h, collision_radius};
  if (!grid.feasible(start_x, start_y) || !grid.feasible(goal_x, goal_y))
    return 0;

  float check_interval = step_size * 0.25f;
  float min_cell = grid.world_w < grid.world_h ? grid.world_w : grid.world_h;
  float cell = step_size < min_cell * 0.25f ? step_size : min_cell * 0.25f;
  if (cell <= 0.f) return -1;

  std::vector<Node> nodes;
  nodes.reserve(4096);
  nodes.push_back({start_x, start_y, -1, 0.f});
  Buckets buckets(world_w, world_h, cell);
  buckets.insert(0, start_x, start_y);

  std::mt19937_64 rng(seed);
  // the reference samples uniformly from [-2000, 2000]^2 (lib.rs:180-185);
  // out-of-world samples are infeasible there too, so sampling the world box
  // is behaviourally identical and avoids wasting 99% of draws.
  std::uniform_real_distribution<float> ux(-world_w * 0.5f, world_w * 0.5f);
  std::uniform_real_distribution<float> uy(-world_h * 0.5f, world_h * 0.5f);

  int goal_node = -1;
  for (int64_t it = 0; it < max_iterations && goal_node < 0; ++it) {
    float sx = ux(rng), sy = uy(rng);
    int near = buckets.nearest(nodes, sx, sy);
    if (near < 0) break;
    float dx = sx - nodes[near].x, dy = sy - nodes[near].y;
    float len = std::sqrt(dx * dx + dy * dy);
    if (len < 1e-9f) continue;
    float scale = len > step_size ? step_size / len : 1.f;
    float nx = nodes[near].x + dx * scale, ny = nodes[near].y + dy * scale;
    if (!grid.feasible(nx, ny)) continue;
    if (!grid.segment_feasible(nodes[near].x, nodes[near].y, nx, ny,
                               check_interval))
      continue;

    // choose best parent within neighbourhood_radius
    int parent = near;
    float seg = std::sqrt((nx - nodes[near].x) * (nx - nodes[near].x) +
                          (ny - nodes[near].y) * (ny - nodes[near].y));
    float best_cost = nodes[near].cost + seg;
    buckets.for_each_in_radius(nx, ny, neighbourhood_radius, [&](int id) {
      float ddx = nodes[id].x - nx, ddy = nodes[id].y - ny;
      float d = std::sqrt(ddx * ddx + ddy * ddy);
      if (d > neighbourhood_radius) return;
      float c = nodes[id].cost + d;
      if (c < best_cost &&
          grid.segment_feasible(nodes[id].x, nodes[id].y, nx, ny,
                                check_interval)) {
        best_cost = c;
        parent = id;
      }
    });

    int new_id = (int)nodes.size();
    nodes.push_back({nx, ny, parent, best_cost});
    buckets.insert(new_id, nx, ny);

    // rewire neighbours through the new node
    buckets.for_each_in_radius(nx, ny, neighbourhood_radius, [&](int id) {
      if (id == new_id) return;
      float ddx = nodes[id].x - nx, ddy = nodes[id].y - ny;
      float d = std::sqrt(ddx * ddx + ddy * ddy);
      if (d > neighbourhood_radius) return;
      float c = best_cost + d;
      if (c < nodes[id].cost &&
          grid.segment_feasible(nx, ny, nodes[id].x, nodes[id].y,
                                check_interval)) {
        nodes[id].parent = new_id;
        nodes[id].cost = c;
      }
    });

    // goal connection (stop_when_reach_goal=true in the reference)
    float gdx = goal_x - nx, gdy = goal_y - ny;
    float gd = std::sqrt(gdx * gdx + gdy * gdy);
    if (gd <= step_size &&
        grid.segment_feasible(nx, ny, goal_x, goal_y, check_interval)) {
      goal_node = (int)nodes.size();
      nodes.push_back({goal_x, goal_y, new_id, best_cost + gd});
    }
  }
  if (goal_node < 0) return 0;

  // walk back to root
  std::vector<int> rev;
  for (int id = goal_node; id >= 0; id = nodes[id].parent) rev.push_back(id);
  std::vector<float> px(rev.size()), py(rev.size());
  for (size_t i = 0; i < rev.size(); ++i) {
    px[i] = nodes[rev[rev.size() - 1 - i]].x;
    py[i] = nodes[rev[rev.size() - 1 - i]].y;
  }

  // shortcut smoothing (rrt::rrtstar::smooth_path analogue): pick two random
  // indices; if the straight segment is feasible, cut out everything between.
  if (smooth_enabled && px.size() > 2) {
    std::uniform_real_distribution<float> u01(0.f, 1.f);
    float interval = smooth_step > 1e-6f ? smooth_step : check_interval;
    for (int64_t it = 0; it < smooth_iterations && px.size() > 2; ++it) {
      size_t n = px.size();
      size_t i = (size_t)(u01(rng) * (float)(n - 1));
      size_t j = (size_t)(u01(rng) * (float)(n - 1));
      if (i > j) std::swap(i, j);
      if (j - i < 2) continue;
      if (grid.segment_feasible(px[i], py[i], px[j], py[j], interval)) {
        px.erase(px.begin() + i + 1, px.begin() + j);
        py.erase(py.begin() + i + 1, py.begin() + j);
      }
    }
  }

  // decimate to max_out keeping endpoints
  int n = (int)px.size();
  if (n > max_out) {
    for (int k = 0; k < max_out; ++k) {
      int idx = (int)((int64_t)k * (n - 1) / (max_out - 1));
      out_xy[2 * k] = px[idx];
      out_xy[2 * k + 1] = py[idx];
    }
    return max_out;
  }
  for (int k = 0; k < n; ++k) {
    out_xy[2 * k] = px[k];
    out_xy[2 * k + 1] = py[k];
  }
  return n;
}

}  // extern "C"
