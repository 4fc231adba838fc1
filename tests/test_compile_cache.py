"""``config.setup_compile_cache``: the environment variable wins, and the
fixed repository path is the default."""

import os

import jax
import pytest

from bayesfast_jax import config


@pytest.fixture
def _restore_cache_dir():
    prev = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update('jax_compilation_cache_dir', prev)


@pytest.mark.parametrize('env_set', [True, False])
def test_setup_compile_cache(env_set, tmp_path, monkeypatch,
                             _restore_cache_dir):
    if env_set:
        monkeypatch.setenv('JAX_COMPILATION_CACHE_DIR', str(tmp_path))
        want = str(tmp_path)
    else:
        monkeypatch.delenv('JAX_COMPILATION_CACHE_DIR', raising=False)
        want = os.path.join(
            os.path.dirname(os.path.dirname(os.path.abspath(
                config.__file__))), '.jax_cache')
    assert config.setup_compile_cache() == want
    assert jax.config.jax_compilation_cache_dir == want
