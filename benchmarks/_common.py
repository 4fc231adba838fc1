"""Shared benchmark plumbing: compile cache, GPU check, device report."""

import os
import subprocess
import sys

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _REPO not in sys.path:
    sys.path.insert(0, _REPO)


def setup_cache():
    """Persistent XLA compile cache (``bayesfast_jax.config``): flat-tree
    NUTS programs take long to compile at large chain counts; pay it once
    per configuration."""
    from bayesfast_jax.config import setup_compile_cache
    return setup_compile_cache()


def require_gpu():
    """Exit non-zero unless JAX's first device is a GPU: a benchmark that
    finds no card fails instead of timing the CPU."""
    import jax
    dev = jax.devices()[0]
    if dev.platform != 'gpu':
        sys.exit(f'no GPU: jax.devices()[0] is {dev.platform!r} '
                 f'({dev.device_kind}); this measurement needs the card.')
    return dev


def gpu_name_and_power_limit():
    """``nvidia-smi``'s name and power limit of each card, one per line."""
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def device_report():
    """What every printed result is measured on."""
    import jax
    dev = jax.devices()[0]
    return {'platform': dev.platform, 'kind': dev.device_kind,
            'count': len(jax.devices()), 'jax': jax.__version__,
            'xla_flags': os.environ.get('XLA_FLAGS', ''),
            'compile_cache': jax.config.jax_compilation_cache_dir,
            'nvidia_smi': gpu_name_and_power_limit()}


def sync(*arrays):
    """Wait until the device work feeding ``arrays`` has finished."""
    import jax
    return jax.block_until_ready(arrays)
