"""The faults of the ``sampler`` kind: the update leaves the state
unchanged; half of each batch left out, the loss's mean taken over the rest."""


def _drop_update(monkeypatch):
    from ursabench_tpu_torch.inference import sgmcmc

    monkeypatch.setattr(sgmcmc.SGHMC, "_UPDATE_FN", staticmethod(lambda *a, **k: None))


def _half_batch_train(monkeypatch):
    from ursabench_tpu_torch.inference import engine

    real = engine._chains_loss_backward

    def half(state, batches, **kw):
        batches = [(x[: x.shape[0] // 2], y[: y.shape[0] // 2]) for x, y in batches]
        aug = kw.get("aug")
        if aug is not None:
            kw["aug"] = [tuple(None if a is None else a[: a.shape[0] // 2] for a in c)
                         for c in aug]
        return real(state, batches, **kw)

    monkeypatch.setattr(engine, "_chains_loss_backward", half)


FAULTS = {"state unchanged": _drop_update, "half the batch": _half_batch_train}
