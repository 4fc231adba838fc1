"""Profile a few post-warmup NUTS transitions of banana-32 on the GPU.

    python benchmarks/nuts_trace.py [--out DIR]

Runs 1024 float32 chains through 200 warmup iterations (untraced), one
untraced chunk of 2 post-warmup transitions so the traced chunk compiles
nothing, then records one chunk of the same length with ``jax.profiler``. The trace reduction
(``reduce_trace``) reads the device plane of the ``.xplane.pb`` file:

* device events (kernels and copies) per tree-loop iteration, where the
  loop iterations are the largest tree of each traced transition (every
  chain advances in lockstep until the last one is done);
* device busy time (union of event intervals) and idle share over the
  device window (first event start to last event end);
* the kernels with the most device time.

Prints one JSON line and writes it, with the trace, under ``--out``.
Exits non-zero without a GPU.
"""

import argparse
import glob
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from _common import device_report, require_gpu, setup_cache  # noqa: E402


def _union_ns(intervals):
    """Total length of the union of (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def reduce_trace(path, plane_prefix='/device:GPU:0'):
    """Device event count, busy time, idle share and top kernels of the
    first plane whose name starts with ``plane_prefix``."""
    import jax
    pd = jax.profiler.ProfileData.from_file(path)
    planes = [p for p in pd.planes if p.name.startswith(plane_prefix)]
    if not planes:
        raise RuntimeError(f'no plane {plane_prefix!r} in {path}: '
                           f'{[p.name for p in pd.planes]}')
    lines = {}
    events = []
    for line in planes[0].lines:
        evs = [(e.start_ns, e.end_ns, e.name) for e in line.events]
        lines[line.name] = len(evs)
        # stream lines hold what actually ran on the device; derived
        # lines ("XLA Modules", "XLA Ops", ...) restate the same time
        if line.name.startswith('Stream'):
            events += evs
    if not events:
        raise RuntimeError(f'no stream events on {planes[0].name}; '
                           f'lines: {lines}')
    busy = _union_ns([(s, e) for s, e, _ in events])
    window = max(e for _, e, _ in events) - min(s for s, _, _ in events)
    per_kernel = {}
    for s, e, name in events:
        t, n = per_kernel.get(name, (0.0, 0))
        per_kernel[name] = (t + (e - s), n + 1)
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1][0])[:12]
    return {'lines': lines, 'n_device_events': len(events),
            'device_busy_ns': busy, 'device_window_ns': window,
            'idle_share': 1.0 - busy / window,
            'top_kernels': [{'name': k[:120], 'total_ns': t, 'count': n}
                            for k, (t, n) in top]}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--out', default='nuts_trace_out')
    args = ap.parse_args()
    n_chain, n_warmup, k = 1024, 200, 2

    import jax
    import jax.numpy as jnp
    setup_cache()
    require_gpu()
    import bayesfast_jax as bf
    from bench import banana_density

    bf.utils.set_generator(32)
    den = banana_density(jnp.float32)
    trace = bf.NTrace(n_chain=n_chain, n_iter=n_warmup + 2 * k,
                      n_warmup=n_warmup)
    tt = bf.sample(den, trace, n_run=n_warmup, verbose=False, n_update=50)
    tt = bf.sample(den, tt, n_run=k, verbose=False, n_update=k)
    os.makedirs(args.out, exist_ok=True)
    t0 = time.perf_counter()
    with jax.profiler.trace(args.out):
        tt = bf.sample(den, tt, n_run=k, verbose=False, n_update=k)
    wall = time.perf_counter() - t0

    size = tt.trace._stats_arrays['tree_size'][:, -k:]
    loop_iters = int(np.sum(size.max(axis=0)))
    path = sorted(glob.glob(os.path.join(
        args.out, 'plugins', 'profile', '*', '*.xplane.pb')))[-1]
    red = reduce_trace(path)
    rec = {'metric': 'nuts_trace_banana32', 'device': device_report(),
           'n_chain': n_chain, 'n_traced_transitions': k,
           'traced_wall_s': wall, 'tree_loop_iterations': loop_iters,
           'mean_tree_size': float(size.mean()),
           'device_events_per_loop_iteration':
               red['n_device_events'] / loop_iters,
           'device_busy_us_per_loop_iteration':
               red['device_busy_ns'] / loop_iters / 1e3,
           'wall_us_per_loop_iteration': wall / loop_iters * 1e6,
           **red}
    line = json.dumps(rec)
    with open(os.path.join(args.out, 'nuts_trace.json'), 'w') as f:
        f.write(line + '\n')
    print(line)


if __name__ == '__main__':
    main()
