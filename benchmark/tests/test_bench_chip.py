"""On the card: the control fails and the program passes at the cells'
own sizes (``python -m pytest benchmark/tests -q -m chip`` on a machine
with one). Elsewhere these tests skip, and the run's look for a chip
ends it without a result."""

import json

import pytest
import torch

from benchmark import control, run


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")


def test_without_a_card_a_run_prints_no_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    rc = run.main(["--workload", "portal.train", "--seed", "1",
                   "--seconds", "1", "--trace", "0"])
    assert rc != 0
    assert capsys.readouterr().out == ""


@pytest.mark.chip
@pytest.mark.parametrize("workload", ["portal.train", "portal.render"])
@pytest.mark.parametrize("system,correct", [("program", True),
                                            ("control", False)])
def test_cell_size_on_the_card(capsys, workload, system, correct):
    _need_card()
    rc = control.main(["--workload", workload, "--system", system,
                       "--seeds", "5", "6", "7", "--seconds", "1"])
    assert rc == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert len(lines) == 3
    assert all(x["correct"] is correct for x in lines), lines
