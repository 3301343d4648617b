"""FD signal-processing utilities: windowing, spectral convolution, adapters.

Rebuilds the reference's ``FDutils.py`` capability surface (behavior pinned
at reference ``FDutils.py:35-178``):

* ``get_convolution(a, b)`` — circular convolution normalized by ``len(b)``
  (``FDutils.py:35-47``: linear convolution of the doubled array, valid mode);
* ``get_fft_td_windowed(signal, window, dt)`` — ``fftshift(fft(h * w)) * dt``
  per channel (``FDutils.py:49-64``);
* ``get_fd_windowed(signal, window)`` — windowing applied *in the frequency
  domain* by spectral convolution with ``conj(fft(window))``
  (``FDutils.py:66-101``);
* adapter classes ``get_fd_waveform_fromFD`` / ``get_fd_waveform_fromTD``
  that mask positive frequencies and zero user-masked bins
  (``FDutils.py:105-178``).

These are host-side analysis utilities (run once per injection, not in the
sampler hot loop), so they use numpy FFTs; `rfft_at_bins` is the jittable
spectrum of the TD likelihood template. The Sokal autocorrelation tools the
reference keeps here live in ``utils.autocorr``.
"""

from __future__ import annotations

import numpy as np
from scipy.signal import fftconvolve


def get_convolution(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Circular convolution of ``a`` and ``b`` normalized by ``len(b)``.

    Matches the reference implementation: linear convolution of
    ``[a[1:], a]`` with ``b`` in 'valid' mode, i.e. the circular convolution
    evaluated at every shift, divided by the window length.
    """
    a = np.asarray(a)
    b = np.asarray(b)
    return fftconvolve(np.hstack((a[1:], a)), b, mode="valid") / len(b)


def rfft_at_bins(h, bin_idx):
    """``rfft(h)[..., bin_idx]`` of a real series as an ``(re, im)`` pair.

    Jittable; an f64 series is transformed in complex128, so the result
    matches ``numpy.fft.rfft`` to f64 rounding at any length, odd ones
    included.
    """
    import jax.numpy as jnp

    spec = jnp.fft.rfft(jnp.asarray(h), axis=-1)[..., jnp.asarray(bin_idx)]
    return spec.real, spec.imag


def get_fft_td_windowed(signal, window, dt: float):
    """FFT of windowed TD channels: ``fftshift(fft(h * w)) * dt``."""
    return [np.fft.fftshift(np.fft.fft(np.asarray(s) * np.asarray(window))) * dt for s in signal]


def get_fd_windowed(signal, window=None, window_in_fd: bool = False):
    """Apply a TD window to FD channels by spectral convolution."""
    if window is None:
        return [np.asarray(s) for s in signal]
    fft_window = np.asarray(window) if window_in_fd else np.fft.fft(np.asarray(window))
    return [get_convolution(np.conj(fft_window), np.asarray(s)) for s in signal]


class get_fd_waveform_fromFD:
    """Adapter: FD generator -> positive-frequency windowed [h+, hx].

    Same constructor/call contract as the reference class: wraps a
    ``return_list`` FD generator, applies optional FD-domain windowing, masks
    to positive frequencies, zeroes ``~non_zero_mask`` bins.
    """

    def __init__(
        self,
        waveform_generator,
        positive_frequency_mask,
        dt,
        non_zero_mask=None,
        window=None,
        window_in_fd=False,
    ):
        self.waveform_generator = waveform_generator
        self.positive_frequency_mask = np.asarray(positive_frequency_mask)
        self.dt = dt
        self.non_zero_mask = None if non_zero_mask is None else np.asarray(non_zero_mask)
        self.window = window
        self.window_in_fd = window_in_fd

    def __call__(self, *args, **kwargs):
        channels = self.waveform_generator(*args, **kwargs)
        channels = get_fd_windowed(channels, self.window, window_in_fd=self.window_in_fd)
        out = [np.asarray(c)[self.positive_frequency_mask].copy() for c in channels]
        if self.non_zero_mask is not None:
            for c in out:
                c[~self.non_zero_mask] = 0.0j
        return out


class get_fd_waveform_fromTD:
    """Adapter: TD generator -> positive-frequency FFT'd windowed [h+, hx]."""

    def __init__(self, waveform_generator, positive_frequency_mask, dt, non_zero_mask=None, window=None):
        self.waveform_generator = waveform_generator
        self.positive_frequency_mask = np.asarray(positive_frequency_mask)
        self.dt = dt
        self.non_zero_mask = None if non_zero_mask is None else np.asarray(non_zero_mask)
        self.window = window  # None -> boxcar

    def __call__(self, *args, **kwargs):
        channels = self.waveform_generator(*args, **kwargs)
        window = np.ones(len(channels[0])) if self.window is None else self.window
        channels = get_fft_td_windowed(channels, window, self.dt)
        out = [np.asarray(c)[self.positive_frequency_mask].copy() for c in channels]
        if self.non_zero_mask is not None:
            for c in out:
                c[~self.non_zero_mask] = 0.0j
        return out


__all__ = [
    "get_convolution",
    "rfft_at_bins",
    "get_fft_td_windowed",
    "get_fd_windowed",
    "get_fd_waveform_fromFD",
    "get_fd_waveform_fromTD",
]
