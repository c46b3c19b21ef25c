"""Faults planted under the timed path, to show that ``correct`` catches
them (the tests at SMOKE size, ``calibrate.py`` on the card at the cell's
own size):

* ``altered_answer`` (prefill): one prompt's logits rolled by one token
  where the step produces them;
* ``unchanged`` (training): the step returns its state as it found it;
* ``half_batch`` (training): the step sees half of the batch and takes
  the mean over it.
"""
from __future__ import annotations

from contextlib import contextmanager
from unittest import mock

FAULTS = {"prefill": ("altered_answer",),
          "train": ("unchanged", "half_batch")}


@contextmanager
def planted(kind_module, fault: str):
    if fault == "altered_answer":
        real = kind_module.Bench._run

        def altered(self, tokens):
            logits, cache, t_call, reply = real(self, tokens)
            logits = logits.clone()
            logits[0, -1] = logits[0, -1].roll(1)
            return logits, cache, t_call, reply

        with mock.patch.object(kind_module.Bench, "_run", altered):
            yield
        return
    import repro_torch.train.step as S

    real_make = S.make_train_step

    def make(*a, **k):
        step = real_make(*a, **k)

        def broken(state, batch):
            if fault == "unchanged":
                before = {n: t.clone() for n, t in state.tree().items()}
                new, metrics = step(state, batch)
                return new.load_tree(before), metrics
            if fault == "half_batch":
                return step(state, {n: v[: v.shape[0] // 2]
                                    for n, v in batch.items()})
            raise ValueError(f"unknown fault {fault!r}")

        return broken

    with mock.patch.object(S, "make_train_step", make):
        yield
