"""``chip_smoke.py``: refuses to run without a GPU, and (marked ``gpu``)
passes on a machine with one.

The script is run in a child process: this test session itself is pinned
to the CPU backend (``conftest.py``).
"""

import os
import shutil
import subprocess
import sys

import pytest

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SCRIPT = os.path.join(_REPO, 'chip_smoke.py')


def _run(cwd, env_update, timeout):
    env = {k: v for k, v in os.environ.items()
           if k not in ('JAX_PLATFORMS', 'XLA_FLAGS')}
    env.update(env_update)
    return subprocess.run([sys.executable, 'chip_smoke.py'], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=timeout)


def test_chip_smoke_fails_without_gpu():
    out = _run(_REPO, {'JAX_PLATFORMS': 'cpu'}, timeout=300)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
    assert 'no GPU' in out.stderr


def test_chip_smoke_fails_outside_the_repo(tmp_path):
    shutil.copy(_SCRIPT, tmp_path / 'chip_smoke.py')
    out = _run(str(tmp_path), {'JAX_PLATFORMS': 'cpu'}, timeout=300)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


@pytest.fixture
def gpu_card():
    """The card's name, or a skip when this machine has no NVIDIA GPU."""
    smi = shutil.which('nvidia-smi')
    if smi is None:
        pytest.skip('no GPU: nvidia-smi not found')
    out = subprocess.run([smi, '-L'], capture_output=True, text=True)
    if out.returncode != 0 or 'GPU' not in out.stdout:
        pytest.skip('no GPU: nvidia-smi lists none')
    return out.stdout.splitlines()[0]


@pytest.mark.gpu
def test_chip_smoke_passes_on_gpu(gpu_card):
    out = _run(_REPO, {}, timeout=1200)
    assert out.returncode == 0, out.stdout[-4000:] + out.stderr[-4000:]
    assert out.stdout.splitlines()[-1].startswith(
        '{"ok": true, "device": {"platform": "gpu"')
