"""Multi-device sharding coverage on the conftest 8-CPU mesh.

The reference is single-device (SURVEY §2.5); the scaling axes here
are walkers (data parallel) and the frequency grid (sequence-parallel
analogue). These tests run the production sharding helpers
(`parallel.mesh`) through real jitted computations on the virtual
8-device mesh and assert agreement with the unsharded results — the same
contract `__graft_entry__.dryrun_multichip` validates, but wired into
pytest so regressions surface in CI.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from emri_frequencydomainwaveforms_tpu.models.amplitude import default_mode_table
from emri_frequencydomainwaveforms_tpu.models.waveform import (
    fd_waveform_core,
    waveform_prologue,
)
from emri_frequencydomainwaveforms_tpu.parallel.mesh import (
    replicated,
    shard_frequency,
    shard_walkers,
    walker_mesh,
)

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs the 8-device CPU mesh"
)

TABLE = default_mode_table(4, l_max=2)
F_NP = 1e-3 + 3e-7 * np.arange(256)
F_ARR = jnp.asarray(F_NP)
UNIFORM = (float(F_NP[0]), float(F_NP[1] - F_NP[0]))


def _gen(p0):
    pro = waveform_prologue(
        1e6, 10.0, p0, 0.3, 0.7, 0.5, 1.0, 0.0, 0.0,
        t_years=0.005, table=TABLE, k_max=8, eps=1e-2, max_steps=64,
    )
    return fd_waveform_core(pro, TABLE, F_ARR, channels=True, uniform=UNIFORM)


def _ll(p0):
    out = _gen(p0)
    return -0.5 * sum(jnp.sum(o * o) for o in out) * 1e34


class TestWalkerSharding:
    def test_sharded_likelihood_matches_unsharded(self):
        mesh = walker_mesh(8)
        p0s = jnp.linspace(9.8, 10.2, 16)

        batched = jax.vmap(_ll)
        expect = np.asarray(jax.jit(batched)(p0s))

        sharded_in = jax.device_put(p0s, NamedSharding(mesh, P("walkers")))
        got = np.asarray(
            jax.jit(batched, out_shardings=NamedSharding(mesh, P("walkers")))(
                sharded_in
            )
        )
        np.testing.assert_allclose(got, expect, rtol=1e-12)

    def test_shard_walkers_helper(self):
        mesh = walker_mesh(8)
        x = jnp.zeros((16, 6))
        xs = jax.device_put(x, shard_walkers(mesh))
        assert len(xs.sharding.device_set) == 8

    def test_walker_psum_reduction(self):
        # cross-shard reduction (the ensemble-move mixing pattern) agrees
        mesh = walker_mesh(8)
        p0s = jnp.linspace(9.8, 10.2, 16)
        sharded = jax.device_put(p0s, shard_walkers(mesh))

        @jax.jit
        def mean_ll(p):
            return jnp.mean(jax.vmap(_ll)(p))

        np.testing.assert_allclose(
            float(mean_ll(sharded)), float(mean_ll(p0s)), rtol=1e-12
        )


class TestFrequencySharding:
    def test_frequency_sharded_generation(self):
        # full-grid generation with the spectrum sharded over the mesh:
        # bins are independent given the spline data, so the sharded and
        # replicated results must agree to the bit
        mesh = walker_mesh(8)

        @jax.jit
        def gen_stacked(p0):
            return jnp.stack(_gen(p0))  # (4, Nf)

        expect = np.asarray(gen_stacked(10.0))
        got = np.asarray(
            jax.jit(gen_stacked, out_shardings=shard_frequency(mesh))(10.0)
        )
        np.testing.assert_array_equal(got, expect)

    def test_replicated_helper(self):
        mesh = walker_mesh(8)
        x = jax.device_put(jnp.arange(8.0), replicated(mesh))
        assert x.sharding.is_fully_replicated


class TestShardedSamplerStep:
    def test_stretch_step_walker_sharded(self):
        from emri_frequencydomainwaveforms_tpu.inference.moves.stretch import (
            StretchMove,
        )

        mesh = walker_mesh(8)
        ntemps, nwalkers, ndim = 2, 16, 3
        key = jax.random.PRNGKey(0)
        coords = jax.random.normal(key, (ntemps, nwalkers, ndim))
        betas = jnp.array([1.0, 0.5])

        def logl(x):
            return -0.5 * jnp.sum(x**2, axis=-1)

        def logp(x):
            return jnp.zeros(x.shape[:-1])

        move = StretchMove()

        def step(coords):
            ll = logl(coords)
            lp = logp(coords)
            out = move.propose(
                jax.random.PRNGKey(7), coords, ll, lp, betas, logp, logl
            )
            return out[0], out[1]

        exp_coords, exp_ll = jax.jit(step)(coords)
        csh = NamedSharding(mesh, P(None, "walkers", None))
        got_coords, got_ll = jax.jit(step)(jax.device_put(coords, csh))
        np.testing.assert_allclose(
            np.asarray(got_coords), np.asarray(exp_coords), rtol=1e-12
        )
        np.testing.assert_allclose(
            np.asarray(got_ll), np.asarray(exp_ll), rtol=1e-12
        )
