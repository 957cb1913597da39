// Simulated-annealing travel-order solver for anchor tours.
//
// Counterpart of perf_tpu/native/tour.cpp (a copy: the port imports nothing of
// the JAX package) and of the reference's Python annealing loop
// (dense_travel_pose_sampler.py:26-48): 10k iterations of random pair swaps
// with a (1 - t)^5 acceptance schedule over the open-path total length.
// The Python loop takes seconds on host; this runs in microseconds and is
// loaded via ctypes (plain C interface).
//
// Built by perf_tpu_torch/native/__init__.py with g++ at first use.

#include <cstdint>
#include <cmath>
#include <cstring>
#include <vector>

namespace {

struct Rng {
  // xorshift64* — deterministic across platforms for test reproducibility
  uint64_t s;
  explicit Rng(uint64_t seed) : s(seed ? seed : 0x9e3779b97f4a7c15ull) {}
  uint64_t next() {
    s ^= s >> 12;
    s ^= s << 25;
    s ^= s >> 27;
    return s * 0x2545F4914F6CDD1Dull;
  }
  double uniform() { return (next() >> 11) * (1.0 / 9007199254740992.0); }
  int64_t below(int64_t n) { return static_cast<int64_t>(next() % n); }
};

double path_length(const float* pts, const int64_t* order, int64_t n) {
  double total = 0.0;
  for (int64_t i = 0; i + 1 < n; ++i) {
    const float* a = pts + order[i] * 3;
    const float* b = pts + order[i + 1] * 3;
    double dx = a[0] - b[0], dy = a[1] - b[1], dz = a[2] - b[2];
    total += std::sqrt(dx * dx + dy * dy + dz * dz);
  }
  return total;
}

}  // namespace

extern "C" {

// positions: [n, 3] float32; order_out: [n] int64 (pre-allocated).
// Returns the final path length.
double solve_tour(const float* positions, int64_t n, int64_t n_steps,
                  uint64_t seed, int64_t* order_out) {
  std::vector<int64_t> order(n), cand(n);
  for (int64_t i = 0; i < n; ++i) order[i] = i;
  Rng rng(seed);
  double best = path_length(positions, order.data(), n);
  for (int64_t step = 0; step < n_steps; ++step) {
    cand = order;
    int64_t a = rng.below(n), b = rng.below(n);
    std::swap(cand[a], cand[b]);
    double len = path_length(positions, cand.data(), n);
    double ratio = std::pow(1.0 - double(step) / double(n_steps), 5.0);
    if (len < best || rng.uniform() < ratio) {
      order.swap(cand);
      best = len;
    }
  }
  std::memcpy(order_out, order.data(), sizeof(int64_t) * n);
  return best;
}

}  // extern "C"
