"""A run of the benchmark with the timed path broken underneath comes out
not correct: one run a fault the cells can have, each planted in the
program's tracker on the CPU at a small size, past the harness's look for a
card. A sound run at the same size comes out correct."""
import pytest

from portbench import harness
from portbench.tests.conftest import SMALL, small

CELLS = sorted(SMALL)
SEED = 2 ** 31 + 977


def run(name):
    return harness.run(name, SEED, 0.0, False, "cpu", overrides=small(name))


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    result = run(name)
    assert result["correct"], result["checks"]
    assert result["failed"] == 0 and result["attempted"] > 0


def _state_unchanged(monkeypatch):
    """Every step returns the state it was given (its outputs as computed)."""
    from glimpse_tpu_torch.track import batch

    step = batch.BatchTracker.step

    def stuck(self, state, *args, **kwargs):
        _, outputs = step(self, state, *args, **kwargs)
        return state, outputs

    monkeypatch.setattr(batch.BatchTracker, "step", stuck)


def _half_the_particles(monkeypatch):
    """The moments are taken over the first half of each point's particles."""
    from glimpse_tpu_torch.track import batch

    moments = batch.particle_moments

    def half(particles, weights):
        keep = particles.shape[1] // 2
        return moments(particles[:, :keep], weights[:, :keep])

    monkeypatch.setattr(batch, "particle_moments", half)


def _answer_altered(at):
    """A fault that moves one point's mean by one pixel where the step
    produces it, at the measured run's first step or its last."""

    def plant(monkeypatch, name):
        from glimpse_tpu_torch.track import batch

        step = batch.BatchTracker.step
        warm_up = small(name)["traffic"]["warmup_steps"]
        target = warm_up + (1 if at == "first" else SMALL[name]["images"] - 1)
        calls = [0]

        def altered(self, *args, **kwargs):
            new_state, outputs = step(self, *args, **kwargs)
            calls[0] += 1
            if calls[0] == target:
                mean = outputs["mean"].clone()
                mean[0, 0] += 1.0
                outputs = dict(outputs, mean=mean)
            return new_state, outputs

        monkeypatch.setattr(batch.BatchTracker, "step", altered)

    return plant


FAULTS = {
    "state_unchanged": lambda monkeypatch, name: _state_unchanged(monkeypatch),
    "half_the_particles": lambda monkeypatch, name: _half_the_particles(monkeypatch),
    "answer_altered_first_step": _answer_altered("first"),
    "answer_altered_last_step": _answer_altered("last"),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("name", CELLS)
def test_fault_is_not_correct(name, fault, monkeypatch):
    FAULTS[fault](monkeypatch, name)
    result = run(name)
    assert not result["correct"], result["checks"]
