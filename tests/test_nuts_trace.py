"""The device-busy reduction of ``benchmarks/nuts_trace.py``: busy time is
the length of the union of event intervals, so overlapping and nested
events count once and gaps count as idle."""

import os
import sys

import pytest

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), 'benchmarks'))

from nuts_trace import _union_ns  # noqa: E402


@pytest.mark.parametrize('intervals,busy', [
    ([], 0.0),
    ([(0, 10)], 10.0),
    ([(0, 10), (20, 25)], 15.0),            # a gap is idle
    ([(0, 10), (5, 15)], 15.0),             # overlap counts once
    ([(0, 30), (5, 10), (12, 20)], 30.0),   # nested events
    ([(20, 25), (0, 10), (10, 12)], 17.0),  # unsorted, touching
])
def test_union_ns(intervals, busy):
    assert _union_ns(intervals) == busy
