"""Noise-weighted likelihoods over frequency-domain channels.

Rebuilds the reference's ``LISAanalysistools/lisatools/sampling/likelihood.py``
(pinned at reference ``likelihood.py:80`` inject_signal — PSD from
``noise_fn(freqs)``, right-rule df vector, pre-whitening by sqrt(df/PSD);
``:236`` get_ll — whiten template, ``ll = -1/2 * 4 * sum Re[(d-h)*(d-h)]``;
``:295`` __call__ — parameter transform + ``subset`` micro-batching;
``:399`` GlobalLikelihood — grouped/summed templates).

Differences from the reference:
* the template model is a JITTABLE function ``params_full -> ((hp_re, hp_im),
  (hc_re, hc_im))`` on the stored ``f_arr`` — the whole batched likelihood
  (transform -> waveforms -> whiten -> reduce) compiles to one XLA program
  vmapped over walkers. No host round-trips, no ``.get()``.
* the reference's ``subset`` GPU micro-batching knob is honored via
  `lax.map` chunking (bounds peak memory for huge walker counts) but is no
  longer required for correctness.
* complex data is carried as (re, im) f64 pairs (a choice made for the
  accelerator this package was first built for, which had no complex128;
  ROADMAP Design item 3);
  the host-facing ``inject_signal`` accepts numpy complex channels.
"""

from __future__ import annotations

from typing import Callable, Sequence

import jax
import jax.numpy as jnp
import numpy as np


def df_vector(f_arr):
    """Right-rule spacings with df[0] = df[1] (reference ``:178-180``)."""
    f_arr = jnp.asarray(f_arr)
    d = jnp.diff(f_arr)
    if f_arr.shape[0] < 2:
        return jnp.ones_like(f_arr)
    return jnp.concatenate([d[:1], d])


class Likelihood:
    """Whitened-residual log-likelihood over FD channels.

    Args:
      template_model: jittable ``params_full (ndim_full,) ->``
        ``((hp_re, hp_im), (hc_re, hc_im))`` evaluated on ``f_arr``; or any
        pytree of channel pairs with ``nchannels`` entries.
      nchannels: number of data channels (2 for [h+, hx]).
      f_arr: (Nf,) positive frequencies of the analysis grid.
      parameter_transforms: TransformContainer applied to sampled params.
      subset: optional chunk size for `lax.map` walker micro-batching.
    """

    def __init__(
        self,
        template_model: Callable,
        nchannels: int,
        *,
        f_arr,
        dt: float | None = None,
        parameter_transforms=None,
        subset: int | None = None,
        vectorized: bool = True,
        separate_d_h: bool = False,
        use_gpu=None,
    ):
        del vectorized, use_gpu  # vmap subsumes both knobs
        self.template_model = template_model
        self.nchannels = nchannels
        self.f_arr = jnp.asarray(f_arr)
        self.dt = dt
        self.transform = parameter_transforms
        self.subset = subset
        self.separate_d_h = separate_d_h
        self.noise_factor = None
        self.injection_whitened = None
        self._ll_fn = None
        self._dh_fn = None
        self._last_params = None

    # ---- injection ----
    def inject_signal(
        self,
        data_stream: Sequence,
        noise_fn=None,
        noise_args=(),
        noise_kwargs=None,
        add_noise: bool = False,
        seed: int | None = None,
    ):
        """Store the whitened injection and the whitening vector.

        ``data_stream``: list of ``nchannels`` complex arrays on ``f_arr``.
        """
        from .sensitivity import get_sensitivity

        noise_kwargs = noise_kwargs or {}
        noise_fn = noise_fn or get_sensitivity
        psd = np.asarray(noise_fn(np.asarray(self.f_arr), *noise_args, **noise_kwargs))
        dfv = np.asarray(df_vector(self.f_arr))
        # guard zero-frequency / pathological bins (non-finite PSD values
        # would silently zero the whitening and fake a perfect likelihood)
        bad = ~np.isfinite(psd) | (psd <= 0)
        if bad.all():
            raise ValueError("noise PSD non-finite/non-positive on every bin")
        psd = np.where(bad, np.inf, psd)
        wf = np.sqrt(dfv / psd)
        self.noise_factor = jnp.asarray(wf)

        chans = [np.asarray(c) for c in data_stream]
        if add_noise:
            rng = np.random.default_rng(seed)
            for i, c in enumerate(chans):
                sigma = np.sqrt(psd / (4.0 * dfv))
                noise = sigma * (rng.standard_normal(c.shape) + 1j * rng.standard_normal(c.shape)) / np.sqrt(2.0)
                chans[i] = c + noise
        self.injection_whitened = [
            (jnp.asarray(c.real * wf), jnp.asarray(c.imag * wf)) for c in chans
        ]
        self._build()

    def _build(self):
        d = self.injection_whitened
        wf = self.noise_factor
        template = self.template_model
        transform = self.transform

        def single_ll(params):
            if transform is not None:
                params_full = transform.both_transforms(params[None, :])[0]
            else:
                params_full = params
            channels = template(params_full)
            ll = 0.0
            for (d_re, d_im), (h_re, h_im) in zip(d, channels):
                r_re = d_re - h_re * wf
                r_im = d_im - h_im * wf
                ll = ll + jnp.sum(r_re * r_re + r_im * r_im)
            return -2.0 * ll  # -1/2 * 4 * sum |d-h|^2

        def single_dh(params):
            """(<d|h>, <h|h>) for one walker (reference ``:368`` d_h,
            ``:379`` h_h properties; whitened vectors absorb sqrt(df/PSD),
            so <a|b> = 4 sum Re[a* b])."""
            if transform is not None:
                params_full = transform.both_transforms(params[None, :])[0]
            else:
                params_full = params
            channels = template(params_full)
            dh = 0.0
            hh = 0.0
            for (d_re, d_im), (h_re, h_im) in zip(d, channels):
                hw_re = h_re * wf
                hw_im = h_im * wf
                dh = dh + jnp.sum(d_re * hw_re + d_im * hw_im)
                hh = hh + jnp.sum(hw_re * hw_re + hw_im * hw_im)
            return 4.0 * dh, 4.0 * hh

        self._dh_fn = jax.jit(jax.vmap(single_dh))
        self._single_ll = single_ll
        if self.subset is None:
            self._ll_fn = jax.jit(jax.vmap(single_ll))
        else:
            chunk = self.subset

            @jax.jit
            def chunked(params):
                n = params.shape[0]
                pad = (-n) % chunk
                p = jnp.concatenate([params, jnp.broadcast_to(params[:1], (pad,) + params.shape[1:])]) if pad else params
                blocks = p.reshape(-1, chunk, p.shape[-1])
                out = jax.lax.map(jax.vmap(single_ll), blocks)
                return out.reshape(-1)[:n]

            self._ll_fn = chunked

    def get_ll(self, params, **kwargs):
        return self(params, **kwargs)

    def __call__(self, params, **waveform_kwargs):
        del waveform_kwargs  # baked into the template closure
        if self._ll_fn is None:
            raise RuntimeError("call inject_signal first")
        params = jnp.atleast_2d(jnp.asarray(params))
        self._last_params = params
        return self._ll_fn(params)

    def d_h_h_h(self, params):
        """Matched-filter components per walker: (<d|h>, <h|h>)."""
        if self._dh_fn is None:
            raise RuntimeError("call inject_signal first")
        return self._dh_fn(jnp.atleast_2d(jnp.asarray(params)))

    @property
    def d_h(self):
        """<d|h> of the last ``__call__`` batch (reference ``likelihood.py``
        ``d_h`` property / ``old_likelihood.py:368``)."""
        return self.d_h_h_h(self._last_params)[0]

    @property
    def h_h(self):
        """<h|h> of the last ``__call__`` batch (reference ``:379``)."""
        return self.d_h_h_h(self._last_params)[1]


class GlobalLikelihood(Likelihood):
    """Grouped-template likelihood (reference ``likelihood.py:399``).

    Sums one template per group before the residual: ``get_ll(params,
    groups)`` with ``groups`` mapping each parameter row to a group id; rows
    in the same group describe separate sources coherently summed in the
    data model (the reversible-jump multi-source configuration).
    """

    def get_ll(self, params, groups=None, **kwargs):
        if groups is None:
            return self(params, **kwargs)
        params = jnp.atleast_2d(jnp.asarray(params))
        groups = jnp.asarray(groups)
        n_groups = int(jnp.max(groups)) + 1

        transform = self.transform
        template = self.template_model
        d = self.injection_whitened
        wf = self.noise_factor

        def template_channels(p):
            if transform is not None:
                p = transform.both_transforms(p[None, :])[0]
            return template(p)

        chans = jax.vmap(template_channels)(params)  # pytree with leading row axis

        lls = []
        for g in range(n_groups):
            mask = (groups == g).astype(wf.dtype)
            ll = 0.0
            for (d_re, d_im), (h_re, h_im) in zip(d, chans):
                hg_re = jnp.sum(h_re * mask[:, None], axis=0) * wf
                hg_im = jnp.sum(h_im * mask[:, None], axis=0) * wf
                r_re = d_re - hg_re
                r_im = d_im - hg_im
                ll = ll + jnp.sum(r_re * r_re + r_im * r_im)
            lls.append(-2.0 * ll)
        return jnp.stack(lls)


__all__ = ["Likelihood", "GlobalLikelihood", "df_vector"]
