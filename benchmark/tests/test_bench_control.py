"""The check that decides ``correct`` fails where it must: the control (the
reference computed in TF32, put in the program's place) and each fault
that a cell can have, planted where the program's answers are produced.

The harness is driven without its look for a card (``run_cell``), on the
CPU at small sizes; the tests marked ``cuda`` run the control and the
program at the cells' own sizes on a card.
"""
import pytest
import torch

import jwave_tpu_torch as jt
from benchmark import harness
from benchmark.control import ReferenceApi

BATCH = "modwt-db4-L5.batch-64to8192"
SLIDING = "modwt-db4-L5.sliding-8x512"
VOLUME = "fwt-db4-L6.volume-256"
#: each cell's mix at a size a test run holds
SMALL = {
    BATCH: {"lengths": [64, 90, 300], "samples": 1800, "distinct_inputs": 2, "warmup": 3},
    SLIDING: {"streams": 3, "window": 128, "chunk": 16, "distinct_chunks": 7, "warmup": 2},
    VOLUME: {"shape": [64, 64, 64], "distinct_inputs": 2, "warmup": 1},
}
SEED = 2**32 + 12345


def _run(cell, api, seed=SEED, seconds=0.2, device="cpu", small=True):
    return harness.run_cell(cell, seed, seconds, False, device=device, api=api,
                            mix=SMALL[cell] if small else None)


def _spoil(t: torch.Tensor, fault: str) -> torch.Tensor:
    t = t.clone()
    if fault == "half":  # the second half of the batch (rows, slices) left out
        t[t.shape[0] // 2:] = 0
    elif fault == "altered":  # one answer altered where it is produced
        t.view(-1)[t.numel() // 2] += 1.0
    return t


class _Transform:
    def __init__(self, inner, fault):
        self.inner, self.fault = inner, fault

    def forward(self, *a):
        return _spoil(self.inner.forward(*a), self.fault)

    def reverse(self, *a):
        return _spoil(self.inner.reverse(*a), self.fault)


class Faulty:
    """The program with one fault planted in the calls the cells make."""

    def __init__(self, fault):
        self.fault = fault

    def __getattr__(self, name):
        return getattr(jt, name)

    def modwt(self, *a):
        return _spoil(jt.modwt(*a), self.fault)

    def imodwt(self, *a):
        return _spoil(jt.imodwt(*a), self.fault)

    def Transform(self, basic):  # noqa: N802 (the program's name)
        return _Transform(jt.Transform(basic), self.fault)

    def sliding_modwt_update(self, state, samples, wavelet, level):
        new = jt.sliding_modwt_update(state, samples, wavelet, level)
        if self.fault == "unchanged":  # the step returns its state as it was
            return state
        chunk = samples.shape[-1]
        cols = new.coeffs[..., -chunk:]
        if self.fault == "half":  # half of the streams not advanced
            cols = torch.cat([cols[: cols.shape[0] // 2],
                              state.coeffs[cols.shape[0] // 2:, :, -chunk:]])
        elif self.fault == "altered":
            cols = _spoil(cols, "altered")
        return new._replace(coeffs=torch.cat([new.coeffs[..., :-chunk], cols], -1))


@pytest.mark.parametrize("cell", list(SMALL))
def test_the_program_passes_at_a_small_size(cell):
    run = _run(cell, None)
    assert run.requests > 0
    assert harness.correct(run), run.checks


@pytest.mark.parametrize("cell", list(SMALL))
def test_the_control_fails(cell):
    run = _run(cell, ReferenceApi())
    assert not harness.correct(run), run.checks
    # the TF32 reference departs by its rounding, far above the limits
    assert all(v > 3 * lim for v, lim in run.checks.values()), run.checks


FAULTS = [(c, f) for c in (BATCH, VOLUME) for f in ("half", "altered")] + [
    (SLIDING, f) for f in ("unchanged", "half", "altered")]


@pytest.mark.parametrize("cell,fault", FAULTS, ids=[f"{c}-{f}" for c, f in FAULTS])
def test_a_fault_makes_the_run_incorrect(cell, fault):
    run = _run(cell, Faulty(fault))
    assert not harness.correct(run), run.checks
    assert run.failed > 0


@pytest.mark.cuda
@pytest.mark.parametrize("cell", list(SMALL))
def test_on_the_card_at_the_cells_size_the_control_fails_and_the_program_passes(cell, card):
    for seed in (SEED, SEED + 1, SEED + 2):
        control = _run(cell, ReferenceApi(), seed=seed, seconds=1.0, device=card, small=False)
        assert not harness.correct(control), control.checks
        program = _run(cell, None, seed=seed, seconds=1.0, device=card, small=False)
        assert harness.correct(program), program.checks
