"""The frozen work count repeats exactly and agrees with the program's own
count (`sail_tpu_torch.utils.opcount.live_ops`) on today's tree."""
import pytest

from perfbench.conftest import tiny_cell
from perfbench import opcount


@pytest.mark.parametrize("name", ["cornell_mirror.fwdbwd",
                                  "lights_and_quadrics.render"])
def test_count_repeats_and_agrees_with_the_program(name):
    from sail_tpu_torch.utils import opcount as program
    from sail_tpu_torch import scenes
    cell = tiny_cell(name)
    t = cell["traffic"]
    a = opcount.count_cell(cell["config"], t, samples=2, row_step=2)
    assert a == opcount.count_cell(cell["config"], t, samples=2,
                                   row_step=2)
    params, static = getattr(scenes, cell["workload"]["config"])().pack()
    want = program.live_ops(params, static, t["size"], t["size"], t["spp"],
                            0, t["bounces"], samples=2, row_step=2)
    assert (a["k1_ops"], a["k2_ops"]) == want


def test_recorded_counts_are_reproduced():
    """The counts kept in the workload files are `count_cell`'s of the
    cells' own configurations, sizes and counting parameters."""
    from perfbench import harness
    for name in ("cornell_mirror.fwdbwd", "lights_and_quadrics.render"):
        cell = harness.load_cell(name)
        work = cell["workload"]["work"]
        assert opcount.count_cell(cell["config"], cell["traffic"],
                                  **work["counted_from"]) == work
