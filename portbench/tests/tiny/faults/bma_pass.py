"""The faults of the ``bma_pass`` kind, planted in the members' logits: one
answer altered where it is produced; half of the batch left out (its
logits zeroed)."""


def _member_logits(monkeypatch, change):
    from ursabench_tpu_torch.inference.ensemble import Ensemble

    real = Ensemble.member_logits
    monkeypatch.setattr(Ensemble, "member_logits",
                        lambda self, x, *a, **k: change(real(self, x, *a, **k)))


def _alter_one_answer(monkeypatch):
    def alter(logits):
        logits = logits.clone()
        logits[0, 0, 0] += 3.0
        return logits

    _member_logits(monkeypatch, alter)


def _half_batch_eval(monkeypatch):
    def half(logits):
        logits = logits.clone()
        logits[:, logits.shape[1] // 2:] = 0.0
        return logits

    _member_logits(monkeypatch, half)


FAULTS = {"an answer altered": _alter_one_answer, "half the batch left out": _half_batch_eval}
