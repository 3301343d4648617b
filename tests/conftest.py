"""Test configuration: run everything on a virtual 8-device CPU mesh.

Multi-device sharding paths are validated on XLA's host-platform virtual
devices (the same pattern ``__graft_entry__.dryrun_multichip`` uses).
Platform selection goes through ``jax.config`` so that it holds whatever
the environment says.
"""

import jax

from emri_frequencydomainwaveforms_tpu.utils.compile_cache import enable_compile_cache

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)
jax.config.update("jax_enable_x64", True)

# persistent XLA compile cache: the suite is compile-dominated (big jitted
# programs, small data), so warm-cache reruns are several times faster
enable_compile_cache()
