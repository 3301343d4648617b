"""emri_frequencydomainwaveforms_tpu: frequency-domain EMRI waveforms in JAX.

A from-scratch JAX/XLA rebuild of the capability surface of
lorenzsp/EMRI_FrequencyDomainWaveforms (frequency-domain EMRI waveforms per
arXiv:2307.12585) + its vendored stack (Eryn ensemble MCMC,
LISAanalysistools likelihoods) + the external FastEMRIWaveforms compute core
it drives.

Everything on the hot path is pure-functional, jittable and vmappable:

* ``models``    — trajectory ODE, amplitudes, mode selection, TD/FD summation,
                  user-facing waveform generators.
* ``ops``       — numerics substrate: batched cubic splines, tridiagonal
                  solves, Bessel functions, 2-D interpolation.
* ``lisa``      — LISA sensitivity/PSD zoo, inner products, likelihoods.
* ``inference`` — tempered ensemble MCMC (stretch moves, temperature ladder),
                  priors, transforms, backends.
* ``parallel``  — device-mesh sharding helpers (walker/frequency axes).
* ``utils``     — constants, spin-weighted harmonics, windows, ACT tools.

Precision: EMRI phases reach ~1e6 rad, so the package enables float64 at
import; the phase spine requires it.
"""

from __future__ import annotations

import jax

jax.config.update("jax_enable_x64", True)

__version__ = "0.1.0"
