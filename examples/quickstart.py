"""Quickstart: generate an FD EMRI waveform and evaluate a likelihood.

Run from the repository root (on the GPU when JAX finds one; force the CPU
with JAX_PLATFORMS=cpu):

    PYTHONPATH=. python examples/quickstart.py
"""

import numpy as np

import emri_frequencydomainwaveforms_tpu  # noqa: F401  (f64 config)
import jax
import jax.numpy as jnp

from emri_frequencydomainwaveforms_tpu.models.amplitude import default_mode_table
from emri_frequencydomainwaveforms_tpu.models.inspiral import get_p_at_t
from emri_frequencydomainwaveforms_tpu.models.waveform import (
    default_frequencies,
    fd_waveform_core,
    waveform_prologue,
)

print("devices:", jax.devices())

# source: M = 1e6 Msun, mu = 10 Msun, 0.2-yr observation
M, mu, e0, T, dt = 1e6, 10.0, 0.35, 0.2, 10.0
p0 = float(get_p_at_t(M, mu, e0, 0.99 * T))
print(f"p0 for a 0.99*T inspiral: {p0:.4f}")

table = default_mode_table(30)
freq = default_frequencies(T, dt)
f_np = freq[freq > 0][::10]
f_arr = jnp.asarray(f_np)
uniform = (float(f_np[0]), float(f_np[1] - f_np[0]))


@jax.jit
def waveform(p0, e0):
    pro = waveform_prologue(
        M, mu, p0, e0, 0.7, 0.5, 1.0, 0.0, 0.0,
        t_years=T, table=table, k_max=48, eps=1e-2,
    )
    return fd_waveform_core(pro, table, f_arr, channels=True, uniform=uniform)


hpr, hpi, hcr, hci = waveform(p0, e0)
hp = np.asarray(hpr) + 1j * np.asarray(hpi)
print(
    f"FD waveform on {len(f_np)} bins: peak |h+~| = {np.abs(hp).max():.3e}, "
    f"nonzero bins = {(np.abs(hp) > 0).sum()}, finite = {np.isfinite(hp).all()}"
)
