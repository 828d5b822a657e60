"""Faults planted under the timed path, for the tests that see ``correct``
come out false and for reading a fault's numbers on the card
(``tools/control.py --fault``). Each patches the program for the rest of
the process (or until ``undo`` is called)."""

from __future__ import annotations

SERVE = ("altered", "half_batch")
TRAIN = ("unchanged", "half_batch")


def plant(kind: str, driver: str):
    """Plant fault ``kind`` in the ``driver``'s timed path; returns undo()."""
    if driver == "serve":
        return _serve(kind)
    return _train(kind)


def _serve(kind: str):
    from deepl_project_tpu_torch.serving import InferenceEngine

    compute = InferenceEngine._compute

    def broken(self, op, x, out_dtype):
        y = compute(self, op, x, out_dtype).clone()
        if kind == "altered":  # one answer of each group: its neighbour's image
            y[0] = y[1 % y.shape[0]] if y.shape[0] > 1 else 255 - y[0]
        elif kind == "half_batch":  # the second half of each group left out
            y[y.shape[0] // 2:] = 0
        else:
            raise ValueError(kind)
        return y

    InferenceEngine._compute = broken
    return lambda: setattr(InferenceEngine, "_compute", compute)


def _train(kind: str):
    from deepl_project_tpu_torch.training import trainer as trainer_mod
    from deepl_project_tpu_torch.training.optim import _Chain

    if kind == "unchanged":  # the step returns with the state as it was
        step = _Chain.step
        _Chain.step = lambda self, grads: True
        return lambda: setattr(_Chain, "step", step)
    if kind != "half_batch":
        raise ValueError(kind)
    init = trainer_mod.Trainer.__init__

    def half(self, *a, **k):  # each step sees the first half of its batch
        init(self, *a, **k)
        inner = self.step_fn
        self.step_fn = lambda state, batch: inner(state, batch[: batch.shape[0] // 2])

    trainer_mod.Trainer.__init__ = half
    return lambda: setattr(trainer_mod.Trainer, "__init__", init)
