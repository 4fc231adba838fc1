"""Test configuration: run on a virtual 8-device CPU mesh.

This is the device-mesh analog of multi-node testing without a cluster
(SURVEY.md §4): sharding/collective code paths are exercised on
``xla_force_host_platform_device_count=8`` fake CPU devices.

The platform is set through ``jax.config`` before any backend is
initialized, so the tests stay on the CPU even on a machine with a GPU.
Tests marked ``gpu`` run their GPU work in a child process instead (see
``tests/test_chip_smoke.py``).
"""

import os

os.environ['XLA_FLAGS'] = (os.environ.get('XLA_FLAGS', '') +
                           ' --xla_force_host_platform_device_count=8').strip()

import jax  # noqa: E402

jax.config.update('jax_platforms', 'cpu')
jax.config.update('jax_enable_x64', True)
