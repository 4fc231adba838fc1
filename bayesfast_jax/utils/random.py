"""Global RNG key registry.

JAX counterpart of the reference's process-global numpy Generator
(``bayesfast/utils/random.py:11-32``): a module-level ``jax.random`` key with
``get/set`` accessors, plus ``spawn_generator`` implemented with
``jax.random.split`` instead of ``bit_generator.jumped`` (per-chain stream
separation with the counter-based Threefry PRNG).
"""

import jax
import numpy as np

__all__ = ['get_generator', 'set_generator', 'spawn_generator', 'next_key']

_key = None


def get_generator():
    """Return the current global PRNG key (creating a default one if unset)."""
    global _key
    if _key is None:
        _key = jax.random.PRNGKey(np.random.SeedSequence().entropy % (2**63))
    return _key


def set_generator(seed_or_key):
    """Set the global PRNG key from an int seed or an existing key."""
    global _key
    if isinstance(seed_or_key, (int, np.integer)):
        _key = jax.random.PRNGKey(int(seed_or_key))
    else:
        _key = seed_or_key


def next_key(n=None):
    """Split off fresh key(s) from the global key, advancing it.

    This plays the role of 'consuming' the global generator in the reference
    (e.g. ``get_generator().normal()`` after spawning).
    """
    global _key
    key = get_generator()
    if n is None:
        _key, sub = jax.random.split(key)
        return sub
    keys = jax.random.split(key, n + 1)
    _key = keys[0]
    return keys[1:]


def spawn_generator(current_key, n, jump_current=True):
    """Derive ``n`` independent keys from ``current_key``.

    Mirrors ``spawn_generator`` in the reference (``utils/random.py:20-32``)
    but with key splitting. ``jump_current`` advances the global key if
    ``current_key`` is the global one.
    """
    n = int(n)
    if n <= 0:
        raise ValueError('n should be a positive int.')
    keys = jax.random.split(jax.random.fold_in(current_key, 0x5b), n)
    if jump_current:
        global _key
        if _key is not None and (np.asarray(_key) == np.asarray(current_key)).all():
            _key = jax.random.split(_key)[0]
    return list(keys)
