"""A run's check against broken program paths and against the controls.

Each fault is planted in the package under test where it produces its
output, a tiny cell runs on the CPU through the whole harness but its
look for a card, and ``correct`` has to come out false; a sound run has
to come out true.  The controls (the reference one precision lower, or
with a table of fewer bits, in the program's place) have to fail the
cell's limits.  On the card (``-m cuda``) one run of each cell's control
and program at the cell's own size does the same."""
import pytest

from palace_tpu_torch.models import scoring
from palace_tpu_torch.ops.count_table import CountTable
from palace_tpu_torch.search import eref
from portbench import calibrate
from portbench.harness import cell
from portbench.tests import _tiny


@pytest.mark.parametrize("kind,dtype", [("score", "float32"), ("score", "bfloat16"),
                                        ("eref", "float32")])
def test_sound_run_is_correct(kind, dtype):
    assert _tiny.run(_tiny.parts(kind, dtype))["correct"] is True


def test_score_answer_altered(monkeypatch):
    real = scoring.score_sequences

    def altered(*args, **kwargs):
        out = real(*args, **kwargs)
        name, p = out[len(out) // 2]
        out[len(out) // 2] = (name, p + 0.01)
        return out

    monkeypatch.setattr(scoring, "score_sequences", altered)
    res = _tiny.run(_tiny.parts("score"))
    assert res["correct"] is False and res["checks"]["prob_gap_max"]["value"] > 0.009


def test_score_half_the_batch_left_out(monkeypatch):
    real = scoring._host_batch

    def half(seqs, device):
        n = len(seqs) // 2
        return real(list(seqs[:n]) + ["AAAA"] * (len(seqs) - n), device)

    monkeypatch.setattr(scoring, "_host_batch", half)
    assert _tiny.run(_tiny.parts("score"))["correct"] is False


def test_eref_state_returned_unchanged(monkeypatch):
    monkeypatch.setattr(CountTable, "add_packed", lambda self, *a, **k: self)
    res = _tiny.run(_tiny.parts("eref"))
    assert res["correct"] is False and res["checks"]["table_slots_wrong"]["value"] > 0


def test_eref_half_the_batch_left_out(monkeypatch):
    real = CountTable.add_packed

    def half(self, packed, mask, perm, k):
        n = packed.shape[0] // 2
        return real(self, packed[:n], mask[:n], perm, k)

    monkeypatch.setattr(CountTable, "add_packed", half)
    assert _tiny.run(_tiny.parts("eref"))["correct"] is False


def test_eref_answer_altered(monkeypatch):
    real = eref.hit_from_good

    def altered(*args, **kwargs):
        hit = real(*args, **kwargs)
        if hit is not None:
            hit.covered += 1
        return hit

    monkeypatch.setattr(eref, "hit_from_good", altered)
    res = _tiny.run(_tiny.parts("eref"))
    assert res["correct"] is False and res["checks"]["report_lines_wrong"]["value"] > 0


@pytest.mark.parametrize("kind,dtype", [("score", "float32"), ("score", "bfloat16"),
                                        ("eref", "float32")])
def test_control_fails_the_limits(kind, dtype):
    parts = _tiny.parts(kind, dtype)
    control = dict(parts["limits"]["control"])
    if "table_bits" in control:   # the tiny table's bits, one fewer
        control["table_bits"] = parts["config"]["kmer"]["k"] - 1
    numbers, _ = calibrate.readings(parts, _tiny.SEED, _tiny.CPU, control)
    limits = parts["limits"]["checks"]
    assert any(numbers[n] > spec["limit"] for n, spec in limits.items()), numbers


@pytest.mark.cuda
@pytest.mark.parametrize("name", [w["name"] for w in _tiny.bench()["workloads"]])
def test_cell_on_the_card(name, cuda):
    """One sample of the program and one of the control at the cell's own
    size: the program within every limit, the control past one."""
    parts = cell.find_cell(_tiny.bench(), name)
    limits = parts["limits"]["checks"]
    for control in (None, parts["limits"]["control"]):
        numbers, _ = calibrate.readings(parts, 97, cuda, control)
        passed = all(numbers[n] <= spec["limit"] for n, spec in limits.items())
        assert passed == (control is None), (control, numbers)
