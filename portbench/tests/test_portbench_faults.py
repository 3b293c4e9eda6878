"""Each fault a cell can have, planted under the timed path, turns
``correct`` false: the harness runs the cell on the CPU at small widths
(it skips only the look for a chip) with the program broken underneath."""

import pytest

from portbench.tests.tiny import run_cell

TRAIN = ["tasu15.train_half_audio", "tasu15.train_text_only"]


@pytest.mark.parametrize("cell", TRAIN)
def test_state_left_unchanged(cell, monkeypatch):
    from ps_slm_tpu_torch.training import train_state

    monkeypatch.setattr(train_state.MultiSteps, "step", lambda self: False)
    out, _ = run_cell(cell)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("cell", TRAIN)
def test_half_the_batch_left_out(cell, monkeypatch):
    from ps_slm_tpu_torch.models import tasu

    forward = tasu.forward

    def half(model, batch, **kw):
        batch = dict(batch)
        labels = batch["labels"].clone()
        labels[labels.shape[0] // 2:] = tasu.IGNORE_ID
        batch["labels"] = labels
        return forward(model, batch, **kw)

    monkeypatch.setattr(tasu, "forward", half)
    out, _ = run_cell(cell)
    assert not out["correct"], out["checks"]


def test_a_served_token_altered(monkeypatch):
    from ps_slm_tpu_torch.inference import continuous

    finish = continuous._SlotPoolBase._finish

    def altered(self, slot, cap):
        key, toks = finish(self, slot, cap)
        toks = list(toks)
        toks[len(toks) // 2] = (int(toks[len(toks) // 2]) + 1) % 256
        return key, toks

    monkeypatch.setattr(continuous._SlotPoolBase, "_finish", altered)
    out, _ = run_cell("tasu15.decode_backlog")
    assert not out["correct"], out["checks"]
