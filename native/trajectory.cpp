// Host-side Schwarzschild-eccentric inspiral integrator (C++ reference).
//
// Native counterpart of models/integrate.py + models/flux.py: the same
// flux-driven ODE (exact geodesic E/L/frequencies + Peters-Mathews fluxes
// through the exact Jacobian) integrated with an adaptive Dormand-Prince
// 5(4) stepper. Mirrors the role of the C++ integrator inside the reference
// engine (few.trajectory, reference SURVEY §2.4) in THIS architecture:
//   * golden cross-validation of the jittable JAX integrator (tests),
//   * fast one-off host solves (duration root-finds at CLI startup on
//     CPU-only machines) without pulling in XLA.
//
// Exposed through ctypes (see native/__init__.py): plain-C ABI, caller
// allocates the knot buffers.

#include <cmath>
#include <cstdint>
#include <algorithm>

namespace {

constexpr double kPi = 3.14159265358979323846;
constexpr int kNChi = 256;

struct Derivs {
  double pdot, edot, omega_phi, omega_r;
};

// exact geodesic E(p, e), L(p, e)
inline void energy_angmom(double p, double e, double* E, double* L) {
  const double denom = p - 3.0 - e * e;
  *E = std::sqrt((p - 2.0 - 2.0 * e) * (p - 2.0 + 2.0 * e) / (p * denom));
  *L = p / std::sqrt(denom);
}

// fundamental frequencies by trapezoid over the Darwin angle (spectral for
// smooth periodic integrands; same scheme as models/geodesic.py)
inline void fundamental_frequencies(double p, double e, double* om_phi,
                                    double* om_r) {
  double t_r = 0.0, dphi = 0.0;
  const double h = 2.0 * kPi / kNChi;
  const double root_e = std::sqrt((p - 2.0) * (p - 2.0) - 4.0 * e * e);
  for (int i = 0; i < kNChi; ++i) {
    const double chi = h * i;
    const double ecos = e * std::cos(chi);
    const double rad = p - 6.0 - 2.0 * ecos;
    const double sq = std::sqrt(rad);
    dphi += std::sqrt(p) / sq;
    t_r += p * p * root_e /
           ((p - 2.0 - 2.0 * ecos) * (1.0 + ecos) * (1.0 + ecos) * sq);
  }
  t_r *= h;
  dphi *= h;
  *om_r = 2.0 * kPi / t_r;
  *om_phi = dphi / t_r;
}

inline Derivs rhs(double p, double e, double nu) {
  const double e_safe = std::max(e, 1e-9);
  // Peters-Mathews orbit-averaged fluxes (per nu)
  const double ome2 = 1.0 - e_safe * e_safe;
  const double fac = ome2 * std::sqrt(ome2);
  const double de_flux = -(32.0 / 5.0) * std::pow(p, -5.0) * fac *
                         (1.0 + (73.0 / 24.0) * e_safe * e_safe +
                          (37.0 / 96.0) * std::pow(e_safe, 4));
  const double dl_flux = -(32.0 / 5.0) * std::pow(p, -3.5) * fac *
                         (1.0 + (7.0 / 8.0) * e_safe * e_safe);

  // exact Jacobian d(E, L)/d(p, e) by central differences (h tuned for
  // ~1e-10 relative accuracy; the reference integrator role tolerates it)
  const double hp = 1e-6 * std::max(1.0, std::abs(p));
  const double he = 1e-7;
  double Epp, Epm, Lpp, Lpm, Eep, Eem, Lep, Lem;
  energy_angmom(p + hp, e_safe, &Epp, &Lpp);
  energy_angmom(p - hp, e_safe, &Epm, &Lpm);
  energy_angmom(p, e_safe + he, &Eep, &Lep);
  energy_angmom(p, std::max(e_safe - he, 0.0), &Eem, &Lem);
  const double dEdp = (Epp - Epm) / (2.0 * hp);
  const double dLdp = (Lpp - Lpm) / (2.0 * hp);
  const double e_lo = std::max(e_safe - he, 0.0);
  const double dEde = (Eep - Eem) / (e_safe + he - e_lo);
  const double dLde = (Lep - Lem) / (e_safe + he - e_lo);

  const double det = dEdp * dLde - dEde * dLdp;
  Derivs d;
  d.pdot = nu * (dLde * de_flux - dEde * dl_flux) / det;
  d.edot = nu * (-dLdp * de_flux + dEdp * dl_flux) / det;
  fundamental_frequencies(p, e_safe, &d.omega_phi, &d.omega_r);
  return d;
}

inline void rhs4(const double* y, double nu, double* dy) {
  Derivs d = rhs(y[0], y[1], nu);
  dy[0] = d.pdot;
  dy[1] = d.edot;
  dy[2] = d.omega_phi;
  dy[3] = d.omega_r;
}

// Dormand-Prince 5(4) tableau
const double A[7][6] = {
    {},
    {1.0 / 5},
    {3.0 / 40, 9.0 / 40},
    {44.0 / 45, -56.0 / 15, 32.0 / 9},
    {19372.0 / 6561, -25360.0 / 2187, 64448.0 / 6561, -212.0 / 729},
    {9017.0 / 3168, -355.0 / 33, 46732.0 / 5247, 49.0 / 176, -5103.0 / 18656},
    {35.0 / 384, 0.0, 500.0 / 1113, 125.0 / 192, -2187.0 / 6784, 11.0 / 84}};
const double B5[7] = {35.0 / 384,    0.0,          500.0 / 1113, 125.0 / 192,
                      -2187.0 / 6784, 11.0 / 84,   0.0};
const double B4[7] = {5179.0 / 57600, 0.0,           7571.0 / 16695, 393.0 / 640,
                      -92097.0 / 339200, 187.0 / 2100, 1.0 / 40};

}  // namespace

extern "C" {

// Integrate d[p, e, Phi_phi, Phi_r]/dt (geometric time, units of M).
// Outputs adaptive knots into t_out (max_steps) / y_out (max_steps x 4);
// returns the live knot count (knot 0 = initial condition), or -1 on
// argument error. Stops at t_max or at p <= 6 + 2e + delta_p_stop.
int64_t integrate_inspiral(double p0, double e0, double nu, double t_max,
                           double rtol, double atol, double h_max_frac,
                           double delta_p_stop, int64_t max_steps,
                           double* t_out, double* y_out) {
  if (max_steps < 2 || !t_out || !y_out) return -1;
  double y[4] = {p0, e0, 0.0, 0.0};
  double t = 0.0, h = 100.0;
  const double h_max = t_max * h_max_frac;

  t_out[0] = 0.0;
  for (int j = 0; j < 4; ++j) y_out[j] = y[j];
  int64_t count = 1;

  double k[7][4];
  int64_t iters = 0, max_iters = 16 * max_steps;
  while (count < max_steps && iters++ < max_iters) {
    h = std::min(h, t_max - t);
    // stages
    for (int s = 0; s < 7; ++s) {
      double ys[4];
      for (int j = 0; j < 4; ++j) {
        ys[j] = y[j];
        for (int q = 0; q < s; ++q) ys[j] += h * A[s][q] * k[q][j];
      }
      rhs4(ys, nu, k[s]);
    }
    double y5[4], err_norm = 0.0;
    bool bad = false;
    for (int j = 0; j < 4; ++j) {
      double y5j = y[j], y4j = y[j];
      for (int s = 0; s < 7; ++s) {
        y5j += h * B5[s] * k[s][j];
        y4j += h * B4[s] * k[s][j];
      }
      y5[j] = y5j;
      const double scale = atol + rtol * std::max(std::abs(y[j]), std::abs(y5j));
      const double e_j = (y5j - y4j) / scale;
      err_norm += e_j * e_j;
      if (!std::isfinite(y5j)) bad = true;
    }
    err_norm = std::sqrt(err_norm / 4.0);
    if (bad) err_norm = 1e10;

    const bool accept = err_norm <= 1.0;
    double fac = 0.9 * std::pow(std::max(err_norm, 1e-16), -0.2);
    fac = std::min(std::max(fac, 0.2), 5.0);
    double h_next = std::min(std::max(h * (accept ? fac : std::min(fac, 1.0)), 1e-6), h_max);

    const bool hit_stop = y5[0] <= 6.0 + 2.0 * y5[1] + delta_p_stop;
    const bool tiny = h <= std::max(1e-3, 1e-9 * t_max);
    if (accept && hit_stop && !tiny) {
      h = 0.5 * h;  // refine onto the stop surface
      continue;
    }
    if (accept) {
      t += h;
      for (int j = 0; j < 4; ++j) y[j] = y5[j];
      t_out[count] = t;
      for (int j = 0; j < 4; ++j) y_out[4 * count + j] = y[j];
      ++count;
      if (hit_stop || t >= t_max * (1.0 - 1e-12)) break;
    }
    h = h_next;
  }
  return count;
}

// Seconds until the separatrix cutoff (or cap), via repeated integration.
double inspiral_duration(double p0, double e0, double nu, double t_cap) {
  constexpr int64_t kMax = 2048;
  static thread_local double t_buf[kMax];
  static thread_local double y_buf[4 * kMax];
  int64_t n = integrate_inspiral(p0, e0, nu, t_cap, 1e-11, 1e-11, 1.0 / 128.0,
                                 0.12, kMax, t_buf, y_buf);
  if (n < 1) return -1.0;
  return t_buf[n - 1];
}

}  // extern "C"
