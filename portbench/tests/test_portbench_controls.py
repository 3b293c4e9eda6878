"""The controls that set the limits' upper readings, at a size a test run
holds: the reference in fp8 or over half of each batch in the program's
place (training cells), the program's int4 path (the serving cell).  Each
reads far above the program, which at these float32 widths reads at
rounding; on the H100 at the cells' own sizes they fail the limits
(PERF.md)."""

import pytest

from portbench.tests.tiny import run_cell


@pytest.mark.parametrize("cell", ["tasu15.train_half_audio", "tasu15.train_text_only"])
@pytest.mark.parametrize("control", ["fp8", "half_batch"])
def test_training_controls_read_far_above_the_program(cell, control):
    prog, _ = run_cell(cell)
    ctl, _ = run_cell(cell, control=control)
    assert ctl["checks"]["grad_diff"]["value"] > 0.1
    for k in ("grad_diff", "change_gap"):
        assert prog["checks"][k]["value"] < 1e-4


def test_serving_control_reads_far_above_the_program():
    prog, _ = run_cell("tasu15.decode_backlog")
    ctl, _ = run_cell("tasu15.decode_backlog", control="int4")
    assert prog["checks"]["served_gap"]["value"] < 1e-3
    assert ctl["checks"]["served_gap"]["value"] > 0.1
