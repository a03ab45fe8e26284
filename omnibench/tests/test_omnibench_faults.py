"""Each fault planted under the timed path of a tiny cell on the CPU
(``omnibench/tests/faults.py``) turns ``correct`` false: a served
score raised, half of each chunk served nothing, a history that never
advances."""

from __future__ import annotations

import pytest

from omnibench.tests.test_omnibench_harness import run_tiny


@pytest.mark.parametrize("fault", ["answer_altered", "half_batch_dropped",
                                   "state_unchanged"])
def test_a_fault_under_the_timed_path_is_not_correct(tmp_path, fault):
    assert run_tiny(tmp_path, fault=fault)["result"]["correct"] is False

