"""Tiny sizes of the cells for the CPU tests, and the checkout on the path."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

#: each cell cut to 2^10 ids and 2^14 edges in windows of 2^10 (16 a pass)
TINY = {
    "cc_s23_w1m": {
        "config": {"generator": {"scale": 10, "edges": 1 << 14}, "id_bound": 1 << 10,
                   "program": {"min_vertex_capacity": 1 << 10}},
        "workload": {"window_edges": 1 << 10},
    },
    "pr_s22_w1m": {
        "config": {"generator": {"scale": 10, "edges": 1 << 14}, "id_bound": 1 << 10,
                   "program": {"id_bound": 1 << 10}},
        "workload": {"window_edges": 1 << 10},
    },
}


@pytest.fixture
def tiny():
    return TINY
