"""CPU checks of the pieces the GPU bring-up rests on.

The TD-template spectrum (`utils.fdutils.rfft_at_bins`, replacing a chunked
f32 DFT), the eccentric RWZ residual contraction (now at HIGHEST
precision), the hi/lo f64 split of the banded FD kernel, the compile-cache
location shared by every entry point, the profiler-trace reduction kept
with the benchmark, and the smoke test's refusal to run without a GPU.
"""

import glob
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("n_t, ds, batched", [
    (1001, 1, False),      # odd length, every bin
    (31557, 100, False),   # odd length, downsampled like the PE template
    (4097, 7, True),       # batched series ride the leading axes
])
def test_td_spectrum_matches_numpy_rfft(n_t, ds, batched):
    from emri_frequencydomainwaveforms_tpu.utils.fdutils import rfft_at_bins

    rng = np.random.default_rng(n_t)
    h = rng.normal(size=(3, n_t) if batched else (n_t,)) * 1e-21
    idx = np.arange(1, (n_t + 1) // 2)[::ds]
    re, im = jax.jit(rfft_at_bins)(jnp.asarray(h), idx)
    ref = np.fft.rfft(h, axis=-1)[..., idx]
    got = np.asarray(re) + 1j * np.asarray(im)
    assert got.shape == ref.shape
    assert np.linalg.norm(got - ref) / np.linalg.norm(ref) < 1e-12


def _keys_np(s):
    a = np.abs(s)
    inner = (1.5 * a - 2.5) * a * a + 1.0
    outer = ((-0.5 * a + 2.5) * a - 4.0) * a + 2.0
    return np.where(a < 1.0, inner, np.where(a < 2.0, outer, 0.0))


def test_rwz_ecc_residual_matches_numpy_bicubic():
    from emri_frequencydomainwaveforms_tpu.models import _rwz_ecc_data as ecc
    from emri_frequencydomainwaveforms_tpu.models.rwz_calibration import (
        rwz_ecc_residual,
    )

    keys = sorted(ecc.R_TABLE)[:: max(1, len(ecc.R_TABLE) // 12)]
    ls, ms, ns = (np.array([k[i] for k in keys]) for i in range(3))
    rng = np.random.default_rng(3)
    u = ecc.U0 + ecc.DU * (ecc.N_U - 1) * rng.random(40)
    e = ecc.E0 + ecc.DE * (ecc.N_E - 1) * rng.random(40)
    r_re, r_im = rwz_ecc_residual(ls, ms, ns, jnp.asarray(u), jnp.asarray(e))
    got = np.asarray(r_re) + 1j * np.asarray(r_im)

    # plain f64 Keys-cardinal bicubic with edge-replicated ghost nodes
    tu = np.clip((u - ecc.U0) / ecc.DU, 0.0, ecc.N_U - 1.0)
    te = np.clip((e - ecc.E0) / ecc.DE, 0.0, ecc.N_E - 1.0)
    wu = _keys_np(tu[:, None] - np.arange(-1, ecc.N_U + 1))
    we = _keys_np(te[:, None] - np.arange(-1, ecc.N_E + 1))
    ref = np.empty_like(got)
    for j, k in enumerate(keys):
        t = np.asarray(ecc.R_TABLE[k], complex).reshape(ecc.N_U, ecc.N_E)
        t = np.pad(t, 1, mode="edge")
        ref[:, j] = np.einsum("pu,ue,pe->p", wu, t, we)
    mag = np.abs(ref)
    ref = ref * np.clip(mag, 0.15, 6.0) / np.maximum(mag, 1e-30)
    assert np.max(np.abs(got - ref)) < 1e-6 * np.max(np.abs(ref))


def test_split_hi_lo_reconstructs_f64():
    from emri_frequencydomainwaveforms_tpu.models.summation_fd import _split_hi_lo

    rng = np.random.default_rng(0)
    x = rng.normal(size=1000) * 10.0 ** rng.integers(-12, 7, size=1000)
    hi, lo = jax.jit(_split_hi_lo)(jnp.asarray(x))
    assert hi.dtype == jnp.float32 and lo.dtype == jnp.float32
    np.testing.assert_array_equal(np.asarray(hi), x.astype(np.float32))
    back = np.asarray(hi, np.float64) + np.asarray(lo, np.float64)
    assert np.max(np.abs(back - x) / np.abs(x)) < 2.0**-47


@pytest.mark.parametrize("env_dir", [None, "from-env"])
def test_compile_cache_location(monkeypatch, tmp_path, env_dir):
    from emri_frequencydomainwaveforms_tpu.utils import compile_cache

    before = jax.config.jax_compilation_cache_dir
    try:
        if env_dir is None:
            monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
            path = compile_cache.enable_compile_cache()
            assert path == os.path.join(REPO, ".jax_cache")
            assert jax.config.jax_compilation_cache_dir == path
        else:
            want = str(tmp_path / env_dir)
            monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", want)
            jax.config.update("jax_compilation_cache_dir", want)  # as JAX reads it
            assert compile_cache.enable_compile_cache() == want
            assert jax.config.jax_compilation_cache_dir == want
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


@pytest.mark.parametrize("value, op, threshold, ok", [
    (1e-4, "<", 1e-3, True),
    (1e-2, "<", 1e-3, False),
    (188, "<=", 188, True),
    (0.99, ">=", 0.9875, True),
    (float("nan"), "<", 1e-3, False),
    (float("nan"), ">=", 0.9875, False),
    ([], "==", [], True),
])
def test_gate_comparisons(value, op, threshold, ok):
    sys.path.insert(0, REPO)
    import bench

    assert bench.gate_passes(value, op, threshold) is ok


def test_chip_smoke_refuses_cpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    assert "no GPU" in proc.stderr


def test_trace_reduction_finds_named_scope_under_vmap(tmp_path):
    sys.path.insert(0, REPO)
    from tools.trace_dense_pass import dense_hlo_ops, reduce_trace

    def lane(x):
        with jax.named_scope("dense_scope"):
            y = jnp.sin(x) * 3.0 + 1.0
        return jnp.cumsum(y) * x

    fn = jax.jit(jax.vmap(lane))
    x = jnp.ones((4, 20000))
    compiled = fn.lower(x).compile()
    hlo = compiled.as_text()
    module = re.search(r"^HloModule (\S+?),", hlo, re.M).group(1)
    ops = dense_hlo_ops(hlo, "dense_scope")
    assert ops
    compiled(x).block_until_ready()
    with jax.profiler.trace(str(tmp_path)):
        for _ in range(2):
            compiled(x).block_until_ready()
    path = glob.glob(str(tmp_path / "**" / "*.xplane.pb"), recursive=True)[0]
    red = reduce_trace(path, module, ops, plane_prefix="/host:CPU",
                       line_prefix="tf_XLA")
    assert red["kernel_events"] > 0
    assert 0.0 < red["dense_pass_s"] <= sum(d for _, _, d in red["events"]) * 1e-9
    assert 0.0 < red["device_busy_s"]
